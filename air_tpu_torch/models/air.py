"""The AIR forward pass: ``max_steps`` attention steps with ACT-style stop
masks, in the sequential ("scan") layout.

Counterpart of ``air_forward`` in ``air_tpu/models/air.py``, step for step:

  * the z_pres KL is masked by the PRE-update stopping sum; the scale, shift
    and VAE KLs and the canvas write by the POST-update sum;
  * the canvas accumulates ``z_pres * window_recon`` for unfinished items;
  * the reconstruction loss is the BCE ``log(x + RECON_EPS)`` exactly as the
    JAX package writes it.

``st_impl="inline"`` takes the attention read and the write-accumulate
through ``air_tpu_torch.kernels.st_inline`` (hand-written CUDA kernels that
build the bilinear weights inside); ``st_impl="pallas"`` through
``air_tpu_torch.kernels.st_pallas`` (the read) and ``st_fused`` (the
write-accumulate), hand-written CUDA kernels with the dense weight matrices
streamed in. Both take their kernels' plain versions on the CPU.
``st_impl="xla"`` takes the read and the write through the plain products
of ``air_tpu_torch.ops.transformer``.

Every random draw is an input. ``noise`` holds, per step, the scale eps
``[B, 1]``, the shift eps ``[B, 2]``, the VAE latent eps ``[B, latent]``, the
VAE output noise ``[B, ws*ws]`` and the z_pres uniforms ``[B]``, stacked over
steps (``draw_noise``). Without it the draws come from ``generator``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from air_tpu_torch.kernels.st_fused import fused_write_accumulate
from air_tpu_torch.kernels.st_inline import (inline_attention_read,
                                             inline_write_accumulate)
from air_tpu_torch.kernels.st_pallas import pallas_attention_read
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.nn.cnn import cnn_apply, cnn_init
from air_tpu_torch.nn.layers import two_layer_head_apply, two_layer_head_init
from air_tpu_torch.nn.lstm import lstm_apply, lstm_init, lstm_zero_state
from air_tpu_torch.nn.vae import vae_apply, vae_init
from air_tpu_torch.ops.concrete import (concrete_binary_kl_mc_sample,
                                        concrete_binary_pre_sigmoid_sample)
from air_tpu_torch.ops.gaussian import gaussian_kl, sample_from_mvn
from air_tpu_torch.ops.schedules import resolve_annealed
from air_tpu_torch.ops.transformer import attention_read, attention_write

RECON_EPS = 10e-10


class AIROutputs(NamedTuple):
    """Per-item outputs [B, T, ...] and the batch scalars."""
    rec_num_digits: torch.Tensor      # [B] int32
    rec_scales: torch.Tensor          # [B, T, 1]
    rec_shifts: torch.Tensor          # [B, T, 2]
    rec_st_back: torch.Tensor         # [B, T, 2, 3]
    rec_windows: torch.Tensor         # [B, T, ws*ws]
    rec_latents: torch.Tensor         # [B, T, latent]
    z_pres_probs: torch.Tensor        # [B, T]
    z_pres: torch.Tensor              # [B, T] (relaxed, or rounded at eval)
    z_pres_kls: torch.Tensor          # [B, T]
    scale_kls: torch.Tensor           # [B, T]
    shift_kls: torch.Tensor           # [B, T]
    vae_kls: torch.Tensor             # [B, T]
    reconstruction: torch.Tensor      # [B, canvas**2], clipped to [0, 1]
    reconstruction_loss: torch.Tensor  # [B]
    kl_loss: torch.Tensor             # [B]
    per_example_loss: torch.Tensor    # [B]
    loss: torch.Tensor                # [] mean total loss
    accuracy: torch.Tensor            # [] digit-count accuracy


def check_supported(config: AIRConfig) -> None:
    """Raise for a configuration whose path the port does not have yet."""
    if config.decoder_layout != "scan":
        raise NotImplementedError(
            "decoder_layout='stepparallel' comes with the throughput-layouts "
            "slice of the port; use decoder_layout='scan'")
    if config.st_pad_mode != "zeros":
        raise NotImplementedError("the port implements st_pad_mode='zeros'")
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            "compute_dtype='bfloat16' comes with the throughput-layouts slice")
    if config.rnn_input_hoist:
        raise NotImplementedError(
            "rnn_input_hoist comes with the throughput-layouts slice")


def init_air_params(generator: torch.Generator, config: AIRConfig,
                    background_init=None) -> dict:
    """The AIR parameter tree, with the keys, shapes and dtypes of the JAX
    package's ``init_air_params``, drawn from ``generator`` on its device
    (convolution weights OIHW).

    ``background_init``: optional [canvas**2] (or [canvas, canvas]) pixel-
    space background estimate in [0, 1] for ``learn_background``, stored as
    its logit after clipping to [1e-3, 1 - 1e-3]; without it the background
    starts at -4 (sigmoid(-4) ~= 0.018, an almost blank canvas)."""
    gen = generator
    units, ws2 = config.rnn_units, config.windows_size ** 2
    params = {
        "lstm": lstm_init(gen, config.rnn_input_dim, units),
        "scale_mean": two_layer_head_init(gen, units,
                                          config.scale_hidden_units, 1),
        "scale_log_variance": two_layer_head_init(
            gen, units, config.scale_hidden_units, 1),
        "shift_mean": two_layer_head_init(gen, units,
                                          config.shift_hidden_units, 2),
        "shift_log_variance": two_layer_head_init(
            gen, units, config.shift_hidden_units, 2),
        "z_pres_log_odds": two_layer_head_init(
            gen, units, config.z_pres_hidden_units, 1),
        "vae": vae_init(gen, ws2, config.vae_recognition_units,
                        config.vae_latent_dimensions,
                        config.vae_generative_units),
    }
    if config.cnn:
        params["cnn"] = cnn_init(gen, config.cnn_filters)
    if config.learn_background:
        n = config.canvas_size ** 2
        if background_init is not None:
            bg = torch.as_tensor(background_init, dtype=torch.float32,
                                 device=gen.device).reshape(-1)
            if bg.shape[0] != n:
                raise ValueError(f"background_init has {bg.shape[0]} "
                                 f"pixels, expected {n}")
            bg = torch.clamp(bg, 1e-3, 1.0 - 1e-3)
            params["background"] = torch.log(bg) - torch.log1p(-bg)
        else:
            params["background"] = torch.full((n,), -4.0,
                                              dtype=torch.float32,
                                              device=gen.device)
    return params


def draw_noise(config: AIRConfig, batch: int, generator=None,
               device="cuda") -> dict:
    """Every draw of one forward pass, stacked over the steps."""
    t, ws = config.max_steps, config.windows_size
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    return {
        "scale": torch.randn((t, batch, 1), **kw),
        "shift": torch.randn((t, batch, 2), **kw),
        "vae_latent": torch.randn((t, batch, config.vae_latent_dimensions),
                                  **kw),
        "vae_out": torch.randn((t, batch, ws * ws), **kw),
        "z_pres_u": torch.rand((t, batch), **kw),
    }


class _Step(NamedTuple):
    """What one attention step computes from the LSTM output."""
    scale: torch.Tensor
    shift: torch.Tensor
    z_pres_prob: torch.Tensor
    z_pres: torch.Tensor
    z_pres_kl: torch.Tensor
    scale_kl: torch.Tensor
    shift_kl: torch.Tensor
    vae_kl: torch.Tensor
    theta_back: torch.Tensor
    vae_recon: torch.Tensor
    vae_latent: torch.Tensor


def _attend(params: dict, config: AIRConfig, hp: dict,
            images_2d: torch.Tensor, outputs: torch.Tensor, train: bool,
            eps: dict) -> _Step:
    """Heads, sampling, the attention read, the VAE and the per-step KLs."""
    ws = config.windows_size
    batch = images_2d.shape[0]
    read = {"inline": inline_attention_read,
            "pallas": pallas_attention_read}.get(config.st_impl,
                                                 attention_read)

    scale_mean = two_layer_head_apply(params["scale_mean"], outputs)
    scale_log_variance = two_layer_head_apply(params["scale_log_variance"],
                                              outputs)
    scale = torch.sigmoid(sample_from_mvn(eps["scale"], scale_mean,
                                          torch.exp(scale_log_variance)))
    s = scale[:, 0]

    shift_mean = two_layer_head_apply(params["shift_mean"], outputs)
    shift_log_variance = two_layer_head_apply(params["shift_log_variance"],
                                              outputs)
    shift = torch.tanh(sample_from_mvn(eps["shift"], shift_mean,
                                       torch.exp(shift_log_variance)))
    x, y = shift[:, 0], shift[:, 1]

    window = read(images_2d, s, x, y, ws).reshape(batch, ws * ws)
    vae_recon, vae_mean, vae_log_variance, vae_latent = vae_apply(
        params["vae"], window, eps["vae_latent"], eps["vae_out"],
        hp["vae_likelihood_std"])

    zeros = torch.zeros_like(s)
    inv_s = 1.0 / s
    theta_back = torch.stack([
        torch.stack([inv_s, zeros, -x * inv_s], dim=1),
        torch.stack([zeros, inv_s, -y * inv_s], dim=1),
    ], dim=1)                                                 # [B, 2, 3]

    z_pres_log_odds = two_layer_head_apply(params["z_pres_log_odds"],
                                           outputs)[:, 0]
    z_pres_pre_sigmoid = concrete_binary_pre_sigmoid_sample(
        eps["z_pres_u"], z_pres_log_odds, hp["z_pres_temperature"])
    z_pres = torch.sigmoid(z_pres_pre_sigmoid)
    if not train:
        z_pres = torch.round(z_pres)   # eval: the underlying Bernoulli draw
    z_pres_prob = torch.sigmoid(z_pres_log_odds)

    z_pres_kl = concrete_binary_kl_mc_sample(
        z_pres_pre_sigmoid,
        hp["z_pres_prior_log_odds"], hp["z_pres_temperature"],
        z_pres_log_odds, hp["z_pres_temperature"])
    scale_kl = gaussian_kl(scale_mean, scale_log_variance,
                           hp["scale_prior_mean"], hp["scale_prior_variance"])
    shift_kl = gaussian_kl(shift_mean, shift_log_variance,
                           hp["shift_prior_mean"], hp["shift_prior_variance"])
    vae_kl = gaussian_kl(vae_mean, vae_log_variance,
                         hp["vae_prior_mean"], hp["vae_prior_variance"])
    return _Step(scale, shift, z_pres_prob, z_pres, z_pres_kl, scale_kl,
                 shift_kl, vae_kl, theta_back, vae_recon, vae_latent)


def _numeric_flags() -> None:
    """Keep float32 products in full float32 on the card, and make cuDNN's
    convolutions repeat their bits. cuDNN runs float32 convolutions in TF32
    by default, which keeps about three digits; the port is held to the JAX
    package at 1e-4, so both TF32 switches are off. And by default cuDNN
    picks weight-gradient algorithms that sum with atomics, so two runs of a
    train step from one state part in the CNN's gradients at step 0 and
    then drift apart; with ``deterministic`` they give the same bits, as
    the JAX package does (scripts/determinism_torch_train.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def air_forward(params: dict, config: AIRConfig, images: torch.Tensor,
                target_num_digits: torch.Tensor, train: bool | None = None,
                hparams: dict[str, Any] | None = None, step=None,
                noise: dict | None = None,
                generator: torch.Generator | None = None) -> AIROutputs:
    """Full AIR forward pass and losses on a [B, canvas**2] batch, on the
    device of ``images``.

    ``train`` defaults to ``config.train``; ``hparams`` (annealed scalar
    overrides) defaults to resolving ``config.annealing_schedules`` at
    ``step`` (or the static config values when both are None).
    """
    check_supported(config)
    if train is None:
        train = config.train
    if hparams is None:
        hp = (config.annealable_defaults() if step is None else
              resolve_annealed(config.schedules,
                               config.annealable_defaults(), step))
    else:
        hp = dict(config.annealable_defaults())
        hp.update(hparams)

    device = images.device
    if device.type == "cuda":
        _numeric_flags()
    batch = images.shape[0]
    cs, ws = config.canvas_size, config.windows_size
    images = images.to(torch.float32)
    images_2d = images.reshape(batch, cs, cs)
    if noise is None:
        noise = draw_noise(config, batch, generator, device)

    if config.cnn:
        rnn_input = cnn_apply(params["cnn"], images, cs, config.cnn_filters)
    else:
        rnn_input = images

    if config.learn_background:
        running_recon = torch.sigmoid(params["background"]).expand(
            batch, cs * cs)
    else:
        running_recon = torch.zeros((batch, cs * cs), dtype=torch.float32,
                                    device=device)
    lstm_state = lstm_zero_state(batch, config.rnn_units, device)
    stopping_sum = torch.zeros((batch,), dtype=torch.float32, device=device)
    running_loss = torch.zeros((batch,), dtype=torch.float32, device=device)
    running_digits = torch.zeros((batch,), dtype=torch.int32, device=device)
    threshold = hp["stopping_threshold"]

    steps = []
    for t in range(config.max_steps):
        outputs, lstm_state = lstm_apply(params["lstm"], lstm_state,
                                         rnn_input)
        a = _attend(params, config, hp, images_2d, outputs, train,
                    {k: v[t] for k, v in noise.items()})
        s, x, y = a.scale[:, 0], a.shift[:, 0], a.shift[:, 1]

        running_loss = running_loss + torch.where(
            stopping_sum < threshold, a.z_pres_kl, 0.0)
        stopping_sum = stopping_sum + (1.0 - a.z_pres)
        alive = stopping_sum < threshold
        running_digits = running_digits + alive.to(torch.int32)

        if config.st_impl in ("inline", "pallas"):
            # coeff = alive * z_pres is exactly where(alive, z_pres * wr, 0)
            fused = (inline_write_accumulate if config.st_impl == "inline"
                     else fused_write_accumulate)
            running_recon = fused(running_recon, a.vae_recon, s, x, y,
                                  alive.to(torch.float32) * a.z_pres, cs)
        else:
            window_recon = attention_write(
                a.vae_recon.reshape(batch, ws, ws), s, x, y, cs)
            running_recon = running_recon + torch.where(
                alive[:, None],
                a.z_pres[:, None] * window_recon.reshape(batch, cs * cs), 0.0)

        running_loss = running_loss + torch.where(alive, a.scale_kl, 0.0)
        running_loss = running_loss + torch.where(alive, a.shift_kl, 0.0)
        running_loss = running_loss + torch.where(alive, a.vae_kl, 0.0)
        steps.append(a)

    def over_steps(field: str) -> torch.Tensor:       # [B, T, ...]
        return torch.stack([getattr(a, field) for a in steps], dim=1)

    reconstruction = torch.clamp(running_recon, 0.0, 1.0)
    one_minus = 1.0 - reconstruction
    reconstruction_loss = -torch.sum(
        images * torch.log(reconstruction + RECON_EPS)
        + (1.0 - images) * torch.log(one_minus + RECON_EPS),
        dim=1)

    per_example_loss = running_loss + reconstruction_loss
    accuracy = (target_num_digits.to(device=device, dtype=torch.int32)
                == running_digits).to(torch.float32).mean()
    return AIROutputs(
        rec_num_digits=running_digits,
        rec_scales=over_steps("scale"),
        rec_shifts=over_steps("shift"),
        rec_st_back=over_steps("theta_back"),
        rec_windows=over_steps("vae_recon"),
        rec_latents=over_steps("vae_latent"),
        z_pres_probs=over_steps("z_pres_prob"),
        z_pres=over_steps("z_pres"),
        z_pres_kls=over_steps("z_pres_kl"),
        scale_kls=over_steps("scale_kl"),
        shift_kls=over_steps("shift_kl"),
        vae_kls=over_steps("vae_kl"),
        reconstruction=reconstruction,
        reconstruction_loss=reconstruction_loss,
        kl_loss=running_loss,
        per_example_loss=per_example_loss,
        loss=per_example_loss.mean(),
        accuracy=accuracy,
    )
