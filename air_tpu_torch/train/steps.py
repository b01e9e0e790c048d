"""Train, eval and eval-summary steps.

Counterpart of ``air_tpu/train/steps.py``. The train step is one training
iteration of the reference: the annealed hyperparameters resolved at the
state's own global step, the optional background composite, the forward
pass, the backward pass, the optimizer (``train/state.py``), and the
metrics. With ``st_impl="inline"`` or ``"pallas"`` the attention read and
the write-accumulate run their hand-written kernels on the card
(``"pallas"``: the read's backward as plain products, as the JAX package
takes XLA's there). The step trains through each decoder layout and under
``compute_dtype="bfloat16"``: the gradients, the master params and Adam
stay float32 (``models/air.py``).

The step is split in two. Its host part (``host_scalars``) computes what
depends on the Python step: the annealed hyperparameters, the background
intensity and Adam's bias corrections and step size. Its body
(``make_step_body``) takes tensors only, those scalars as 0-d tensors on
the device. ``make_train_step`` runs both eagerly, one step a call; the
trainer's loops and the seed-parallel step replay the body as a CUDA graph
(``train/fast_pipeline.py``), its scalars, batch and draws written into
static slots before each replay.

Every random draw of a train step comes from a ``torch.Generator`` on the
parameters' device seeded from ``(state.seed, state.step)``, the counterpart
of ``fold_in(key, step)``; the ``noise`` argument overrides it (the tests
feed JAX's draws).
"""

from __future__ import annotations

import torch

from air_tpu_torch.models.air import (AIROutputs, _numeric_flags,
                                      air_forward, draw_noise)
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import resolve_annealed
from air_tpu_torch.train.metrics import summarize_outputs
from air_tpu_torch.train.state import (AdamState, TrainState,
                                       apply_updates, clip_by_global_norm,
                                       global_norm, make_optimizer)
from air_tpu_torch.tree import (path_name, tree_leaves,
                                tree_leaves_with_path, tree_map,
                                tree_unflatten)


# the metrics of every train step, in this order (fast_pipeline stacks them)
TRAIN_METRICS = ("loss", "accuracy", "reconstruction_loss", "kl_loss",
                 "grad_norm", "z_pres_prior_log_odds")


def bg_intensity(schedule: dict | None, step) -> torch.Tensor:
    """Background-curriculum intensity ``s(step)``, float32: 0 until
    ``start``, then a linear ramp over ``ramp`` steps up to ``target``
    (``ramp`` 0 jumps)."""
    schedule = schedule or {}
    f32 = dict(dtype=torch.float32)
    target = torch.tensor(float(schedule.get("target", 1.0)), **f32)
    start = float(schedule.get("start", 0))
    ramp = float(schedule.get("ramp", 0))
    step = torch.tensor(step, **f32)
    if ramp > 0:
        frac = torch.clamp((step - start) / ramp, 0.0, 1.0)
    else:
        frac = (step >= start).to(torch.float32)
    return target * frac


def _splitmix64(x: int) -> int:
    mask = (1 << 64) - 1
    z = (x + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step's draws, from (seed, step). The pair
    is hashed to 64 bits: the CPU generator keeps only the low 32 bits of
    its seed."""
    mixed = _splitmix64(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return torch.Generator(device=device).manual_seed(mixed)


def host_scalars(config: AIRConfig, optimizer, step: int,
                 opt_state: AdamState, schedules: dict | None = None,
                 bg_schedule: dict | None = None) -> dict:
    """The host part of the train step at ``step`` from ``opt_state``:
    each hyperparameter that ``schedules`` (``config.schedules`` by
    default) anneals, resolved by ``resolve_annealed``; the background
    intensity ``bg`` under a ``bg_schedule``; Adam's scalars
    (``Optimizer.host_scalars``). Python floats that are float32 values,
    in that order."""
    if schedules is None:
        schedules = config.schedules
    hp = resolve_annealed(schedules, config.annealable_defaults(), step)
    row = {name: float(hp[name]) for name in schedules}
    if bg_schedule is not None:
        row["bg"] = float(bg_intensity(bg_schedule, step))
    row.update(optimizer.host_scalars(opt_state))
    return row


def device_scalars(row: torch.Tensor, names) -> dict:
    """{name: 0-d view} of a row of step scalars."""
    return dict(zip(names, row.unbind()))


def make_step_body(config: AIRConfig, bg_image=None,
                   with_grad_stats: bool = False):
    """Returns ``body(params, mu, nu, images, targets, noise, scalars) ->
    (params, mu, nu, metrics)``: one train step on tensors only. The
    scalars of the step (``host_scalars``) come as 0-d tensors on the
    images' device; ``mu`` and ``nu`` are Adam's moment trees. Nothing it is
    given is changed. The eager step (``make_train_step``) and the captured
    one (``fast_pipeline``) run this body."""
    optimizer = make_optimizer(config)
    defaults = config.annealable_defaults()
    bg_on = {}        # the background texture on each device, made once

    def body(params, mu, nu, images, targets, noise, scalars):
        device = images.device
        if bg_image is not None:
            if device not in bg_on:
                bg_on[device] = torch.as_tensor(
                    bg_image, dtype=torch.float32, device=device).reshape(-1)
            images = torch.clamp(
                images + scalars["bg"] * bg_on[device][None, :], 0.0, 1.0)
        hp = {**defaults, **{k: v for k, v in scalars.items()
                             if k in defaults}}
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        out = air_forward(leaves, config, images, targets, train=True,
                          hparams=hp, noise=noise)
        if device.type == "cuda":
            _numeric_flags()  # the backward's products too
        grads = tree_unflatten(leaves, torch.autograd.grad(
            out.loss, tree_leaves(leaves)))
        updates, new_mu, new_nu = optimizer.apply(grads, mu, nu, scalars)
        log_odds = hp["z_pres_prior_log_odds"]
        metrics = {
            "loss": out.loss.detach(),
            "accuracy": out.accuracy,
            "reconstruction_loss": out.reconstruction_loss.detach().mean(),
            "kl_loss": out.kl_loss.detach().mean(),
            "grad_norm": global_norm(grads),
            "z_pres_prior_log_odds": (
                log_odds.clone() if isinstance(log_odds, torch.Tensor)
                else torch.full((), log_odds, dtype=torch.float32,
                                device=device)),
        }
        if bg_image is not None:
            metrics["bg_intensity"] = scalars["bg"].clone()
        if with_grad_stats:
            clipped = grads
            if config.gradient_clipping_norm is not None:
                clipped = clip_by_global_norm(grads,
                                              config.gradient_clipping_norm)
            gstats = {}
            for (path, g), gc in zip(tree_leaves_with_path(grads),
                                     tree_leaves(clipped)):
                name = path_name(path)
                gstats[name + "_grad_original_norm"] = torch.linalg.norm(
                    g.ravel())
                gstats[name + "_grad_original_avg"] = torch.mean(g)
                gstats[name + "_grad_applied_norm"] = torch.linalg.norm(
                    gc.ravel())
                gstats[name + "_grad_applied_avg"] = torch.mean(gc)
            metrics["grad_stats"] = gstats
            metrics["grad_tensors"] = {"original": grads, "applied": clipped}
        return apply_updates(params, updates), new_mu, new_nu, metrics

    return body


def check_step_options(bg_image, bg_schedule, pmean_axis=None) -> None:
    if pmean_axis is not None:
        raise NotImplementedError(
            "pmean_axis comes with the multi-GPU slice of the port "
            "(ROADMAP Queue 1)")
    if bg_image is not None and bg_schedule is None:
        raise ValueError("bg_image requires an explicit bg_schedule "
                         "({'target': s, 'start': 0, 'ramp': 0} for a "
                         "constant composite)")


def make_train_step(config: AIRConfig, bg_image=None,
                    bg_schedule: dict | None = None,
                    with_grad_stats: bool = False, pmean_axis=None,
                    schedules_fn=None):
    """Returns ``train_step(state, images, targets, knobs=None, noise=None)
    -> (new_state, metrics)``, run eagerly: the host part
    (``host_scalars``, one copy to the device, the draws) and the body
    (``make_step_body``). ``state`` is left unchanged.

    ``bg_image`` (a [canvas**2] full-intensity texture) composites each
    batch as ``clip(images + s(step) * bg, 0, 1)`` with ``s`` from
    ``bg_schedule`` (``bg_intensity``); it needs an explicit schedule.
    ``with_grad_stats`` adds per-variable norms and means of the gradients
    before and after the clip, and the gradients themselves
    (``metrics["grad_tensors"]``). ``schedules_fn``, a ``knobs ->
    annealing-schedules dict`` callable (``lambda k: multi_seed.
    schedules_from_knobs(config.schedules, k)`` for the sweep's rotation
    knobs), resolves the annealed hyperparameters from
    ``schedules_fn(knobs)`` instead of ``config.schedules``, as the JAX
    package's step does."""
    check_step_options(bg_image, bg_schedule, pmean_axis)
    optimizer = make_optimizer(config)
    body = make_step_body(config, bg_image, with_grad_stats)

    def train_step(state: TrainState, images, targets, knobs=None,
                   noise=None):
        step = state.step
        device = tree_leaves(state.params)[0].device
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        targets = torch.as_tensor(targets, device=device)
        row = host_scalars(
            config, optimizer, step, state.opt_state,
            None if schedules_fn is None else schedules_fn(knobs),
            bg_schedule if bg_image is not None else None)
        scalars = device_scalars(
            torch.tensor(list(row.values()), dtype=torch.float32).to(device),
            row)
        if noise is None:
            noise = draw_noise(config, images.shape[0],
                               step_generator(state.seed, step, device),
                               device)
        params, mu, nu, metrics = body(state.params, state.opt_state.mu,
                                       state.opt_state.nu, images, targets,
                                       noise, scalars)
        return state.replace(
            params=params, opt_state=optimizer.advance(state.opt_state, mu,
                                                       nu),
            step=step + 1), metrics

    return train_step


def make_eval_step(config: AIRConfig):
    """Returns ``eval_step(params, images, targets, step, generator=None,
    noise=None) -> AIROutputs``: the forward pass with ``train=False``
    (z_pres rounded) and the annealed hyperparameters resolved at ``step``,
    run without autograd."""

    def eval_step(params, images, targets, step, generator=None,
                  noise=None) -> AIROutputs:
        hp = resolve_annealed(config.schedules, config.annealable_defaults(),
                              step)
        with torch.no_grad():
            return air_forward(params, config, images, targets, train=False,
                               hparams=hp, noise=noise, generator=generator)

    return eval_step


def make_eval_summary_step(config: AIRConfig):
    """Returns ``eval_summary(params, images, targets, step, generator=None,
    noise=None) -> dict``: the eval forward and the reference's scalar
    summaries (``summarize_outputs``), 0-d tensors on the device."""
    eval_fn = make_eval_step(config)

    def eval_summary(params, images, targets, step, generator=None,
                     noise=None) -> dict:
        out = eval_fn(params, images, targets, step, generator=generator,
                      noise=noise)
        return summarize_outputs(out, targets, config.max_steps,
                                 config.max_digits)

    return eval_summary
