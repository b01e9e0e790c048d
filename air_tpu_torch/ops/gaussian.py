"""Diagonal-Gaussian sampling and closed-form KL.

Counterpart of ``air_tpu/ops/gaussian.py``. The standard-normal noise is
an argument, so the same draws can be fed to both packages.
"""

from __future__ import annotations

import torch


def sample_from_mvn(eps: torch.Tensor, mean: torch.Tensor,
                    diag_variance: torch.Tensor) -> torch.Tensor:
    """Reparameterized sample ``mean + eps * sqrt(diag_variance)``."""
    return mean + eps * torch.sqrt(diag_variance)


def gaussian_kl(mean: torch.Tensor, log_variance: torch.Tensor,
                prior_mean, prior_variance) -> torch.Tensor:
    """KL(N(mean, exp(log_variance)) || N(prior_mean, prior_variance)),
    summed over the trailing axis. The prior is taken as a float32 scalar,
    as JAX takes a Python float (a 0-d CPU tensor enters a CUDA op as a
    scalar, with no copy)."""
    prior_mean = torch.as_tensor(prior_mean, dtype=torch.float32)
    prior_variance = torch.as_tensor(prior_variance, dtype=torch.float32)
    variance = torch.exp(log_variance)
    return 0.5 * torch.sum(
        torch.log(prior_variance) - log_variance - 1.0
        + variance / prior_variance
        + torch.square(mean - prior_mean) / prior_variance,
        dim=-1,
    )
