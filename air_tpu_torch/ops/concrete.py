"""Binary Concrete (Gumbel-sigmoid) sampling and MC KL.

Counterpart of ``air_tpu/ops/concrete.py``. The uniforms behind the
logistic noise are an argument, so the same draws can be fed to both
packages. ``EPS = 10e-10`` (1e-9) as there.
"""

from __future__ import annotations

import torch

EPS = 10e-10


def logistic_noise(u: torch.Tensor) -> torch.Tensor:
    """log(u + eps) - log(1 - u + eps) for u ~ U(0, 1)."""
    return torch.log(u + EPS) - torch.log(1.0 - u + EPS)


def concrete_binary_pre_sigmoid_sample(u: torch.Tensor,
                                       log_odds: torch.Tensor,
                                       temperature) -> torch.Tensor:
    """Pre-sigmoid Concrete sample: (log_odds + logistic noise) / temperature."""
    return (log_odds + logistic_noise(u)) / temperature


def _concrete_log_density(y: torch.Tensor, log_odds,
                          temperature) -> torch.Tensor:
    """Log-density of a binary Concrete distribution at pre-sigmoid y."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    y_times_temp = y * temperature
    return (torch.log(temperature + EPS) - y_times_temp + log_odds
            - 2.0 * torch.log(1.0 + torch.exp(-y_times_temp + log_odds)
                              + EPS))


def concrete_binary_kl_mc_sample(y: torch.Tensor,
                                 prior_log_odds, prior_temperature,
                                 posterior_log_odds, posterior_temperature
                                 ) -> torch.Tensor:
    """Single-sample MC estimate of KL(posterior || prior) at pre-sigmoid y."""
    log_prior = _concrete_log_density(y, prior_log_odds, prior_temperature)
    log_posterior = _concrete_log_density(y, posterior_log_odds,
                                          posterior_temperature)
    return log_posterior - log_prior
