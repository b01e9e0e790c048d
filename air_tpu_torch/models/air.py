"""The AIR forward pass: ``max_steps`` attention steps with ACT-style stop
masks.

Counterpart of ``air_forward`` in ``air_tpu/models/air.py``, step for step:

  * the z_pres KL is masked by the PRE-update stopping sum; the scale, shift
    and VAE KLs and the canvas write by the POST-update sum;
  * the canvas accumulates ``z_pres * window_recon`` for unfinished items;
  * the reconstruction loss is the BCE ``log(x + RECON_EPS)`` exactly as the
    JAX package writes it.

Two decoder layouts (``config.decoder_layout``):

  * ``"scan"``: the steps one after another, each carrying the stop masks,
    the canvas and the losses to the next. It takes every ``st_impl``.
    ``"inline"`` takes the attention read and the write-accumulate through
    ``air_tpu_torch.kernels.st_inline`` (hand-written CUDA kernels that
    build the bilinear weights inside); ``"pallas"`` through
    ``air_tpu_torch.kernels.st_pallas`` (the read) and ``st_fused`` (the
    write-accumulate), hand-written CUDA kernels with the dense weight
    matrices streamed in. Both take their kernels' plain versions on the
    CPU. ``"xla"`` takes the read and the write through the plain products
    of ``air_tpu_torch.ops.transformer``, under either ``st_pad_mode``
    (the kernels take ``"zeros"`` only; ``check_supported``).
  * ``"stepparallel"``: only the LSTM chain runs step by step (its input is
    the same encoding every step and nothing downstream feeds back into
    it); heads, sampling, both transforms and the VAE run once on ``[T*B]``
    rows, and the stop masks are cumulative sums over the steps. It takes
    ``st_impl="xla"`` only (the write kernels are fused with the sequential
    canvas carry) and raises ``ValueError`` otherwise.

Two options apply to both layouts and every ``st_impl``: ``rnn_input_hoist``
computes the input half of the LSTM's gate product once (``nn/lstm.py``),
and ``compute_dtype="bfloat16"`` runs the CNN, the LSTM, the heads and the
VAE's MLPs in bfloat16 while the sampling, the background, the transforms,
the canvas, every KL and the BCE stay float32 (``_cast`` says where the
casts go). At float32 every cast is a no-op.

Every random draw is an input. ``noise`` holds, per step, the scale eps
``[B, 1]``, the shift eps ``[B, 2]``, the VAE latent eps ``[B, latent]``, the
VAE output noise ``[B, ws*ws]`` and the z_pres uniforms ``[B]``, stacked over
steps (``draw_noise``); the step-parallel layout reads them step-major as
``[T*B, ...]``, so each step draws what the scan draws. Without ``noise``
the draws come from ``generator``.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from air_tpu_torch.kernels.st_fused import fused_write_accumulate
from air_tpu_torch.kernels.st_inline import (inline_attention_read,
                                             inline_write_accumulate)
from air_tpu_torch.kernels.st_pallas import pallas_attention_read
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.nn.cnn import cnn_apply, cnn_init
from air_tpu_torch.nn.layers import two_layer_head_apply, two_layer_head_init
from air_tpu_torch.nn.lstm import (lstm_apply, lstm_apply_hoisted, lstm_init,
                                   lstm_input_proj, lstm_zero_state)
from air_tpu_torch.nn.vae import vae_apply, vae_init
from air_tpu_torch.ops.concrete import (concrete_binary_kl_mc_sample,
                                        concrete_binary_pre_sigmoid_sample)
from air_tpu_torch.ops.gaussian import gaussian_kl, sample_from_mvn
from air_tpu_torch.ops.schedules import resolve_annealed
from air_tpu_torch.ops.transformer import attention_read, attention_write
from air_tpu_torch.tree import tree_leaves, tree_map

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
    """Raise ``ValueError`` for a configuration no path takes: the kernels
    of ``st_impl="inline"`` and ``"pallas"`` build the zeros-pad hat only,
    so ``st_pad_mode="clamp_cancel"`` runs on ``st_impl="xla"``, as in the
    JAX package."""
    if (config.st_impl in ("inline", "pallas")
            and config.st_pad_mode != "zeros"):
        raise ValueError(f"st_impl={config.st_impl!r} only implements "
                         "st_pad_mode='zeros'")


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


def noise_shapes(config: AIRConfig, batch: int) -> dict:
    """The shape of each draw of one forward pass (float32 tensors)."""
    t, ws = config.max_steps, config.windows_size
    return {"scale": (t, batch, 1), "shift": (t, batch, 2),
            "vae_latent": (t, batch, config.vae_latent_dimensions),
            "vae_out": (t, batch, ws * ws), "z_pres_u": (t, batch)}


def draw_noise(config: AIRConfig, batch: int, generator=None,
               device="cuda", out: dict | None = None) -> dict:
    """Every draw of one forward pass, stacked over the steps; into the
    tensors of ``out`` (the same keys and shapes) when given, with the same
    draws."""
    draws = {}
    for name, shape in noise_shapes(config, batch).items():
        fn = torch.rand if name == "z_pres_u" else torch.randn
        kw = (dict(dtype=torch.float32, device=device) if out is None
              else {"out": out[name]})
        draws[name] = fn(shape, generator=generator, **kw)
    return draws


class _Step(NamedTuple):
    """What attention steps compute from the LSTM output, independent of the
    stop-mask carry: one step's [B] rows in the scan layout, all steps'
    [T*B] rows in the step-parallel one."""
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


def _cast(tree, dtype: torch.dtype):
    """The params of one use at the compute dtype (a no-op at float32).

    Cast where they are used, once per use: a cast made once and used in
    all ``max_steps`` steps makes autograd sum the steps' cotangents of the
    cast tensor in bfloat16 before converting to the float32 leaf, which
    the JAX package measured to hurt the localization bootstrap. One cast
    per step gives each step's cotangent its own conversion, and the sum
    over steps happens in float32 at the leaf. In the step-parallel layout
    one cast feeds one ``[T*B]`` product, whose weight gradient is one
    float32-accumulated product."""
    return tree_map(lambda a: a.to(dtype), tree)


def _attend(params: dict, config: AIRConfig, hp: dict,
            images_2d: torch.Tensor, outputs: torch.Tensor, train: bool,
            eps: dict) -> _Step:
    """Heads, sampling, the attention read, the VAE and the per-step KLs.
    The head and VAE params are cast to the compute dtype here, and every
    head output is promoted to float32 before sampling."""
    ws = config.windows_size
    rows = images_2d.shape[0]
    cdt = getattr(torch, config.compute_dtype)
    f32 = torch.float32
    read = {"inline": inline_attention_read,
            "pallas": pallas_attention_read}.get(
                config.st_impl, functools.partial(
                    attention_read, pad_mode=config.st_pad_mode))

    def head(name):
        return two_layer_head_apply(_cast(params[name], cdt), outputs).to(f32)

    scale_mean = head("scale_mean")
    scale_log_variance = head("scale_log_variance")
    scale = torch.sigmoid(sample_from_mvn(eps["scale"], scale_mean,
                                          torch.exp(scale_log_variance)))
    s = scale[:, 0]

    shift_mean = head("shift_mean")
    shift_log_variance = head("shift_log_variance")
    shift = torch.tanh(sample_from_mvn(eps["shift"], shift_mean,
                                       torch.exp(shift_log_variance)))
    x, y = shift[:, 0], shift[:, 1]

    window = read(images_2d, s, x, y, ws).reshape(rows, ws * ws)
    vae_recon, vae_mean, vae_log_variance, vae_latent = vae_apply(
        _cast(params["vae"], cdt), window.to(cdt), eps["vae_latent"],
        eps["vae_out"], hp["vae_likelihood_std"])

    zeros = torch.zeros_like(s)
    inv_s = 1.0 / s
    theta_back = torch.stack([
        torch.stack([inv_s, zeros, -x * inv_s], dim=1),
        torch.stack([zeros, inv_s, -y * inv_s], dim=1),
    ], dim=1)                                                 # [B, 2, 3]

    z_pres_log_odds = head("z_pres_log_odds")[:, 0]
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
    """Keep float32 products in full float32 on the card, bfloat16 products
    accumulating in float32, and make cuDNN's convolutions repeat their
    bits. cuDNN runs float32 convolutions in TF32 by default, which keeps
    about three digits; the port is held to the JAX package at 1e-4, so
    both TF32 switches are off. cuBLAS may reduce the split-K partial sums
    of a bfloat16 product in bfloat16; the JAX package accumulates them in
    float32 (``preferred_element_type``), so that is off too. On an H100 it
    changes no bit of the path's products or of a bfloat16 train step
    (scripts/bf16_reduction_torch.py); off, the sums stay float32 whatever
    algorithm cuBLAS picks for another shape. And by
    default cuDNN picks weight-gradient algorithms that sum with atomics,
    so two runs of a train step from one state part in the CNN's gradients
    at step 0 and then drift apart; with ``deterministic`` they give the
    same bits, as the JAX package does (scripts/determinism_torch_train.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def _lstm_step(params: dict, config: AIRConfig, state, rnn_input):
    """One LSTM step at the compute dtype, its params cast for this step.
    ``rnn_input`` is float32: the encoding, or under ``rnn_input_hoist`` its
    gate projection."""
    cdt = getattr(torch, config.compute_dtype)
    lstm = _cast(params["lstm"], cdt)
    apply = lstm_apply_hoisted if config.rnn_input_hoist else lstm_apply
    return apply(lstm, state, rnn_input.to(cdt))


def _scan(params, config, hp, images_2d, rnn_input, init_recon, train,
          noise):
    """The scan layout: (running_recon, running_loss, running_digits, the
    per-step _Step fields stacked [B, T, ...])."""
    batch = images_2d.shape[0]
    cs, ws = config.canvas_size, config.windows_size
    device = images_2d.device
    cdt = getattr(torch, config.compute_dtype)
    running_recon = init_recon
    lstm_state = lstm_zero_state(batch, config.rnn_units, device, cdt)
    stopping_sum = torch.zeros((batch,), dtype=torch.float32, device=device)
    running_loss = torch.zeros((batch,), dtype=torch.float32, device=device)
    running_digits = torch.zeros((batch,), dtype=torch.int32, device=device)
    threshold = hp["stopping_threshold"]

    steps = []
    for t in range(config.max_steps):
        outputs, lstm_state = _lstm_step(params, config, lstm_state,
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
                a.vae_recon.reshape(batch, ws, ws), s, x, y, cs,
                config.st_pad_mode)
            running_recon = running_recon + torch.where(
                alive[:, None],
                a.z_pres[:, None] * window_recon.reshape(batch, cs * cs), 0.0)

        running_loss = running_loss + torch.where(alive, a.scale_kl, 0.0)
        running_loss = running_loss + torch.where(alive, a.shift_kl, 0.0)
        running_loss = running_loss + torch.where(alive, a.vae_kl, 0.0)
        steps.append(a)

    per_step = _Step(*(torch.stack(f, dim=1) for f in zip(*steps)))
    return running_recon, running_loss, running_digits, per_step


def _stepparallel(params, config, hp, images_2d, rnn_input, init_recon,
                  train, noise):
    """The step-parallel layout, with the scan layout's returns: the LSTM
    chain, then one ``_attend`` and one write on the [T*B] rows (step-major,
    as ``jax.vmap`` over the steps lays them out), then the stop masks as
    cumulative sums over the steps."""
    if config.st_impl != "xla":
        raise ValueError("decoder_layout='stepparallel' requires "
                         "st_impl='xla' (the write kernels are fused with "
                         "the sequential canvas carry)")
    batch = images_2d.shape[0]
    steps, cs, ws = config.max_steps, config.canvas_size, config.windows_size
    cdt = getattr(torch, config.compute_dtype)
    rows = steps * batch

    lstm_state = lstm_zero_state(batch, config.rnn_units, images_2d.device,
                                 cdt)
    outputs = []
    for _ in range(steps):
        out, lstm_state = _lstm_step(params, config, lstm_state, rnn_input)
        outputs.append(out)

    images_rows = images_2d.expand(steps, *images_2d.shape).reshape(
        rows, cs, cs)
    a = _attend(params, config, hp, images_rows, torch.cat(outputs), train,
                {k: v.reshape(rows, *v.shape[2:]) for k, v in noise.items()})
    window_recon = attention_write(
        a.vae_recon.reshape(rows, ws, ws), a.scale[:, 0], a.shift[:, 0],
        a.shift[:, 1], cs, config.st_pad_mode).reshape(steps, batch,
                                                       cs * cs)
    a = _Step(*(f.reshape(steps, batch, *f.shape[1:]) for f in a))

    threshold = hp["stopping_threshold"]
    one_minus_zp = 1.0 - a.z_pres                       # [T, B]
    stopping_post = torch.cumsum(one_minus_zp, dim=0)
    stopping_pre = stopping_post - one_minus_zp
    pre_mask = stopping_pre < threshold                 # the z_pres KL's
    alive = stopping_post < threshold                   # every other mask

    running_loss = (
        torch.sum(torch.where(pre_mask, a.z_pres_kl, 0.0), dim=0)
        + torch.sum(torch.where(alive, a.scale_kl + a.shift_kl + a.vae_kl,
                                0.0), dim=0))
    running_digits = torch.sum(alive.to(torch.int32), dim=0,
                               dtype=torch.int32)
    # the background (if any) enters once, after the sum over the steps
    running_recon = init_recon + torch.sum(
        torch.where(alive[:, :, None], a.z_pres[:, :, None] * window_recon,
                    0.0), dim=0)
    per_step = _Step(*(f.transpose(0, 1) for f in a))
    return running_recon, running_loss, running_digits, per_step


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
    cs = config.canvas_size
    cdt = getattr(torch, config.compute_dtype)
    f32 = torch.float32
    images = images.to(f32)
    images_2d = images.reshape(batch, cs, cs)
    if noise is None:
        noise = draw_noise(config, batch, generator, device)

    # The CNN runs once per image, so its params are cast once; its features
    # (and under rnn_input_hoist their gate projection, which reads the
    # input half of the LSTM kernel once per image) stay float32 and each
    # step casts them again, so that the sum of their cotangents over the
    # steps is float32.
    if config.cnn:
        rnn_input = cnn_apply(_cast(params["cnn"], cdt), images.to(cdt), cs,
                              config.cnn_filters).to(f32)
    else:
        rnn_input = images
    if config.rnn_input_hoist:
        rnn_input = lstm_input_proj(_cast(params["lstm"], cdt),
                                    rnn_input.to(cdt)).to(f32)

    if config.learn_background:
        init_recon = torch.sigmoid(params["background"]).expand(
            batch, cs * cs)
    else:
        init_recon = torch.zeros((batch, cs * cs), dtype=f32, device=device)

    layout = (_stepparallel if config.decoder_layout == "stepparallel"
              else _scan)
    running_recon, running_loss, running_digits, a = layout(
        params, config, hp, images_2d, rnn_input, init_recon, train, noise)

    reconstruction = torch.clamp(running_recon, 0.0, 1.0)
    one_minus = 1.0 - reconstruction
    reconstruction_loss = -torch.sum(
        images * torch.log(reconstruction + RECON_EPS)
        + (1.0 - images) * torch.log(one_minus + RECON_EPS),
        dim=1)

    per_example_loss = running_loss + reconstruction_loss
    accuracy = (target_num_digits.to(device=device, dtype=torch.int32)
                == running_digits).to(f32).mean()
    return AIROutputs(
        rec_num_digits=running_digits,
        rec_scales=a.scale,
        rec_shifts=a.shift,
        rec_st_back=a.theta_back,
        rec_windows=a.vae_recon,
        rec_latents=a.vae_latent,
        z_pres_probs=a.z_pres_prob,
        z_pres=a.z_pres,
        z_pres_kls=a.z_pres_kl,
        scale_kls=a.scale_kl,
        shift_kls=a.shift_kl,
        vae_kls=a.vae_kl,
        reconstruction=reconstruction,
        reconstruction_loss=reconstruction_loss,
        kl_loss=running_loss,
        per_example_loss=per_example_loss,
        loss=per_example_loss.mean(),
        accuracy=accuracy,
    )


class AIRModel:
    """Object facade over (config, params, forward), the JAX package's
    ``AIRModel``: construct with a config (or its fields as keywords) and
    optionally params, then call ``forward`` / ``__call__``. Without params
    they are drawn by ``init_air_params`` from ``rng`` (a seed or a
    ``torch.Generator``) on ``device``."""

    def __init__(self, config: AIRConfig | None = None,
                 params: dict | None = None,
                 rng: torch.Generator | int = 0, device="cuda", **kwargs):
        if config is None:
            config = AIRConfig(**kwargs)
        elif kwargs:
            config = config.replace(**kwargs)
        self.config = config
        if params is None:
            if isinstance(rng, int):
                rng = torch.Generator(device=device).manual_seed(rng)
            params = init_air_params(rng, config)
        self.params = params

    def forward(self, images, target_num_digits, train: bool | None = None,
                step=None, noise: dict | None = None,
                generator: torch.Generator | None = None) -> AIROutputs:
        return air_forward(self.params, self.config, images,
                           target_num_digits, train=train, step=step,
                           noise=noise, generator=generator)

    __call__ = forward

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in tree_leaves(self.params))
