"""Single-window VAE.

Counterpart of ``air_tpu/nn/vae.py``: softplus recognition MLP -> diagonal
Gaussian, reparameterized latent, softplus generative MLP -> Gaussian
likelihood with a fixed std whose noise is added before the sigmoid even at
eval. The exposed latent is the recognition MEAN, not the sample. Both
noises are arguments, so the same draws can be fed to both packages.

The MLPs run at the dtype of ``inputs`` and of the params (bfloat16 under
``compute_dtype="bfloat16"``); every sampling step (the latent's mean and
log-variance, the reparameterized sum, the output noise and the sigmoid) is
float32, and the sample is cast down only to feed the generative MLP. At
float32 every cast is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from air_tpu_torch.nn.layers import (dense_apply, dense_init, mlp_apply,
                                     mlp_init)


def vae_init(generator: torch.Generator, input_dim: int, rec_hidden_units,
             latent_dim: int, gen_hidden_units) -> dict:
    rec_dims, gen_dims = list(rec_hidden_units), list(gen_hidden_units)
    return {
        "rec": mlp_init(generator, input_dim, rec_dims),
        "rec_mean": dense_init(generator, rec_dims[-1], latent_dim),
        "rec_log_variance": dense_init(generator, rec_dims[-1], latent_dim),
        "gen": mlp_init(generator, latent_dim, gen_dims),
        "gen_mean": dense_init(generator, gen_dims[-1], input_dim),
    }


def vae_apply(params: dict, inputs: torch.Tensor, latent_eps: torch.Tensor,
              out_noise: torch.Tensor, likelihood_std=0.0,
              activation=F.softplus):
    """Returns (reconstruction, rec_mean, rec_log_variance, latent), all
    float32."""
    f32 = torch.float32
    h = mlp_apply(params["rec"], inputs, activation)
    rec_mean = dense_apply(params["rec_mean"], h).to(f32)
    rec_log_variance = dense_apply(params["rec_log_variance"], h).to(f32)
    rec_sample = rec_mean + latent_eps * torch.sqrt(torch.exp(rec_log_variance))

    h = mlp_apply(params["gen"], rec_sample.to(inputs.dtype), activation)
    gen_mean = dense_apply(params["gen_mean"], h).to(f32)
    reconstruction = torch.sigmoid(gen_mean + out_noise * likelihood_std)
    return reconstruction, rec_mean, rec_log_variance, rec_mean
