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

import functools

import torch

from air_tpu_torch.models.air import (AIROutputs, _numeric_flags,
                                      air_forward, draw_noise)
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import resolve_annealed
from air_tpu_torch.parallel.collectives import (data_sum_, model_axis,
                                                model_sum_)
from air_tpu_torch.parallel.mesh import data_rows, param_sharding
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
# those the forward pass gives, which the data axis averages
FORWARD_METRICS = TRAIN_METRICS[:4]


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


def sharded_leaves(config: AIRConfig, mesh) -> list | None:
    """Per parameter leaf, in leaf order, whether ``mesh``'s model axis
    holds it as column slices; None without a model axis."""
    if mesh is None or mesh.model == 1:
        return None
    return [p is not None for p in param_sharding(mesh, config)]


def make_grad_body(config: AIRConfig, bg_image=None, mesh=None):
    """Returns ``grad(params, images, targets, noise, scalars) -> (grads,
    forward)``: the forward and backward passes of a train step, and the
    step's FORWARD_METRICS of its rows as 0-d tensors. Under ``mesh`` the
    forward runs on its model axis (``parallel.collectives.model_axis``);
    the rows are this rank's, and nothing is averaged here."""
    defaults = config.annealable_defaults()
    bg_on = {}        # the background texture on each device, made once

    def grad(params, images, targets, noise, scalars):
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
        with model_axis(mesh):
            out = air_forward(leaves, config, images, targets, train=True,
                              hparams=hp, noise=noise)
            if device.type == "cuda":
                _numeric_flags()  # the backward's products too
            grads = tree_unflatten(leaves, torch.autograd.grad(
                out.loss, tree_leaves(leaves)))
        return grads, {
            "loss": out.loss.detach(),
            "accuracy": out.accuracy,
            "reconstruction_loss": out.reconstruction_loss.detach().mean(),
            "kl_loss": out.kl_loss.detach().mean(),
        }

    return grad


def make_update_body(config: AIRConfig, with_grad_stats: bool = False,
                     mesh=None):
    """Returns ``update(params, mu, nu, grads, forward, scalars) -> (params,
    mu, nu, metrics)``: the optimizer on the step's gradients and the
    step's metrics (TRAIN_METRICS, then ``bg_intensity`` when the scalars
    hold ``bg``, then the gradient statistics). Under ``mesh`` the norms of
    column-sharded leaves are summed over its model axis."""
    optimizer = make_optimizer(config)
    defaults = config.annealable_defaults()
    sharded = sharded_leaves(config, mesh)
    norm = (global_norm if sharded is None
            else functools.partial(global_norm, mesh=mesh, sharded=sharded))

    def leaf_stats(i, g):
        """(norm, mean) of gradient leaf ``i``, over the model axis when it
        is sharded."""
        if sharded is None or not sharded[i]:
            return torch.linalg.norm(g.ravel()), torch.mean(g)
        sums = model_sum_(torch.stack([torch.sum(g * g), torch.sum(g)]),
                          mesh)
        return torch.sqrt(sums[0]), sums[1] / (g.numel() * mesh.model)

    def update(params, mu, nu, grads, forward, scalars):
        hp = {**defaults, **{k: v for k, v in scalars.items()
                             if k in defaults}}
        updates, new_mu, new_nu = optimizer.apply(grads, mu, nu, scalars,
                                                  norm)
        log_odds = hp["z_pres_prior_log_odds"]
        metrics = {
            **forward,
            "grad_norm": norm(grads),
            "z_pres_prior_log_odds": (
                log_odds.clone() if isinstance(log_odds, torch.Tensor)
                else torch.full((), log_odds, dtype=torch.float32,
                                device=forward["loss"].device)),
        }
        if "bg" in scalars:
            metrics["bg_intensity"] = scalars["bg"].clone()
        if with_grad_stats:
            clipped = grads
            if config.gradient_clipping_norm is not None:
                clipped = clip_by_global_norm(
                    grads, config.gradient_clipping_norm, norm)
            gstats = {}
            for i, ((path, g), gc) in enumerate(zip(
                    tree_leaves_with_path(grads), tree_leaves(clipped))):
                name = path_name(path)
                (gstats[name + "_grad_original_norm"],
                 gstats[name + "_grad_original_avg"]) = leaf_stats(i, g)
                (gstats[name + "_grad_applied_norm"],
                 gstats[name + "_grad_applied_avg"]) = leaf_stats(i, gc)
            metrics["grad_stats"] = gstats
            metrics["grad_tensors"] = {"original": grads, "applied": clipped}
        return apply_updates(params, updates), new_mu, new_nu, metrics

    return update


def pack_grads(grads, forward: dict) -> torch.Tensor:
    """The gradient leaves and the forward metrics in one flat float32
    tensor (leaf order, then FORWARD_METRICS): what the data axis
    averages in one all-reduce."""
    return torch.cat([g.reshape(-1) for g in tree_leaves(grads)]
                     + [torch.stack([forward[k] for k in FORWARD_METRICS])])


def unpack_grads(flat: torch.Tensor, template) -> tuple:
    """(grads shaped as the tree ``template``, forward metrics) from
    ``pack_grads``'s layout, as views of ``flat``."""
    leaves, at = [], 0
    for t in tree_leaves(template):
        leaves.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return (tree_unflatten(template, leaves),
            dict(zip(FORWARD_METRICS, flat[at:].unbind())))


def data_mean(summed: torch.Tensor, template, mesh) -> tuple:
    """(grads, forward metrics) averaged over ``mesh``'s data axis, from
    ``pack_grads``'s tensor summed over it (``data_sum_``): the JAX
    package's ``pmean``. The eager step and ``fast_pipeline``'s captured
    update both take the mean here."""
    return unpack_grads(summed / mesh.data, template)


def make_step_body(config: AIRConfig, bg_image=None,
                   with_grad_stats: bool = False, mesh=None):
    """Returns ``body(params, mu, nu, images, targets, noise, scalars) ->
    (params, mu, nu, metrics)``: one train step on tensors only, the
    forward and backward passes (``make_grad_body``) then the optimizer
    (``make_update_body``). The scalars of the step (``host_scalars``) come
    as 0-d tensors on the images' device; ``mu`` and ``nu`` are Adam's
    moment trees. Nothing it is given is changed. Under ``mesh`` (a
    ``parallel.Mesh``) the images, targets and noise are this rank's rows
    and the gradients and forward metrics are averaged over its data axis
    (``data_mean``) between the two parts. The eager step
    (``make_train_step``) and the captured ones (``fast_pipeline``) run
    these parts."""
    grad = make_grad_body(config, bg_image, mesh)
    update = make_update_body(config, with_grad_stats, mesh)

    def body(params, mu, nu, images, targets, noise, scalars):
        grads, forward = grad(params, images, targets, noise, scalars)
        if mesh is not None:
            grads, forward = data_mean(
                data_sum_(pack_grads(grads, forward), mesh), grads, mesh)
        return update(params, mu, nu, grads, forward, scalars)

    return body


def check_step_options(bg_image, bg_schedule) -> None:
    if bg_image is not None and bg_schedule is None:
        raise ValueError("bg_image requires an explicit bg_schedule "
                         "({'target': s, 'start': 0, 'ramp': 0} for a "
                         "constant composite)")


def local_noise(noise: dict, mesh) -> dict:
    """This rank's rows (axis 1) of a global batch's draws: all of them
    without a ``mesh``."""
    if mesh is None:
        return noise
    return {k: data_rows(torch.as_tensor(v), mesh, 1)
            for k, v in noise.items()}


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
    package's step does.

    ``pmean_axis``, a ``parallel.mesh.Mesh``, makes the step one rank's
    part of a data-parallel step: ``images`` and ``targets`` are its rows
    of the global batch (``shard_batch``), and the gradients and the
    forward metrics are averaged over the data axis, as the JAX package's
    ``pmean``. Every rank draws the global batch's noise from
    ``step_generator(seed, step)`` (or takes the global ``noise`` given)
    and keeps its rows, so any world computes the single-card step on the
    whole batch up to the order of the sums, and a world of one its bits.
    A state sharded on the mesh's model axis (``shard_state``) trains its
    column slices."""
    check_step_options(bg_image, bg_schedule)
    if pmean_axis is not None and not hasattr(pmean_axis, "data_group"):
        raise TypeError(f"pmean_axis: a parallel.mesh.Mesh, got "
                        f"{pmean_axis!r}")
    mesh = pmean_axis
    optimizer = make_optimizer(config)
    body = make_step_body(config, bg_image, with_grad_stats, mesh)
    n_data = 1 if mesh is None else mesh.data

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
            noise = draw_noise(config, images.shape[0] * n_data,
                               step_generator(state.seed, step, device),
                               device)
        noise = local_noise(noise, mesh)
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
