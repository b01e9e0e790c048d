"""Seed-parallel training: S independent AIR models trained at once on one
card.

Counterpart of ``air_tpu/train/multi_seed.py``. The JAX package vmaps its
whole fused train step over a stacked state; here the forward pass runs
under ``torch.func.vmap`` over the replica axis, the backward is one
``torch.autograd.grad`` of the sum of the replicas' losses (the replicas
share no parameter, so each leaf's gradient is its own replica's), and the
optimizer updates the stacked tree (``Optimizer.update_replicas``). The
hand-written kernels' autograd Functions fold the replica axis into the
image axis (``kernels.build.fold_replicas``): with ``st_impl="inline"``
each of kernels 1-4 launches once per attention step for all S*B images.
A vmap that would loop over replicas (an op without a batching rule)
raises instead (``no_vmap_fallback``).

Semantics: replica r is the single-seed run of ``seeds[r]``: its init
(``create_train_state(config, seed)``), its draws (``step_generator(seed,
step)``, drawn outside the vmap and stacked), its epoch permutations of
the shared device-resident set (``multi_seed_perms``: the host loader's,
as ``DeviceDataPipeline`` takes them). Batched products round in another
order than S separate ones, so the replicas agree with the single-seed
runs to rounding, not to the bit (tests/test_torch_multi_seed.py).

Each replica keeps its own clock (``state.step``, [S] on the host), so a
re-seeded replica (``reinit_replica``) restarts its annealing schedules,
and ``rotation_knobs`` give each replica its own bootstrap-schedule variant
as [S] inputs of the schedules (``schedules_from_knobs``).

The step is a host part (``replica_host_scalars``: each replica's annealed
hyperparameters and Adam scalars from its clock and knobs; the draws) and
a body on tensors only (``make_replica_body``). ``make_replica_step`` runs
both eagerly; ``make_multi_seed_step`` captures the body as a CUDA graph
and replays it once per step, the [S] rows, batches and draws written into
static slots before each replay (``fast_pipeline.CapturedStep``).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch
from torch.func import vmap

from air_tpu_torch.data.loader import TrainLoader
from air_tpu_torch.models.air import (_numeric_flags, air_forward,
                                      draw_noise, noise_shapes)
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import resolve_annealed
from air_tpu_torch.train.fast_pipeline import (CapturedStep, check_unroll,
                                               copy_noise)
from air_tpu_torch.train.state import (REPLICA_SCALARS, TrainState,
                                       apply_updates, create_train_state,
                                       global_norm_replicas, make_optimizer,
                                       stack_train_states)
from air_tpu_torch.train.steps import TRAIN_METRICS, step_generator
from air_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

# the seed of the sweep's eval draws, (EVAL_SEED, step): the counterpart of
# fold_in(PRNGKey(0x5EED), step) in the JAX package's sweep
EVAL_SEED = 0x5EED


@contextlib.contextmanager
def no_vmap_fallback():
    """Within the block, an op without a vmap batching rule raises instead
    of running once per replica in a loop."""
    functorch = torch._C._functorch
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        functorch._set_vmap_fallback_enabled(was)


def create_multi_seed_state(config: AIRConfig, seeds,
                            device="cuda") -> TrainState:
    """A stacked TrainState of the single-seed states of ``seeds``."""
    return stack_train_states([create_train_state(config, seed=int(s),
                                                  device=device)
                               for s in seeds])


def _device(state: TrainState) -> torch.device:
    return tree_leaves(state.params)[0].device


def reinit_replica(state: TrainState, config: AIRConfig, index: int,
                   seed: int) -> TrainState:
    """Replica ``index`` replaced by a fresh init of ``seed`` (params,
    moments, clocks at 0); the other replicas are left as they are (stall
    auto-recovery re-seeds only the stalled replica). ``state`` is left
    unchanged."""
    fresh = create_train_state(config, seed=int(seed), device=_device(state))
    where = torch.tensor([index], device=_device(state))

    def put(stacked, new):
        return tree_map(lambda s, n: s.index_copy(0, where, n[None]),
                        stacked, new)

    def restart(clock):
        if clock is None:
            return None
        clock = clock.clone()
        clock[index] = 0
        return clock

    opt, new_opt = state.opt_state, fresh.opt_state
    seeds = list(state.seed)
    seeds[index] = int(seed)
    return state.replace(
        params=put(state.params, fresh.params),
        opt_state=opt._replace(count=restart(opt.count),
                               mu=put(opt.mu, new_opt.mu),
                               nu=put(opt.nu, new_opt.nu),
                               schedule_count=restart(opt.schedule_count)),
        step=restart(state.step), seed=seeds)


def multi_seed_perms(n: int, seeds, epoch: int,
                     device="cuda") -> torch.Tensor:
    """[S, n] int64 epoch permutations on ``device``, one per seed: the host
    loader's ``TrainLoader(seed=s)._perm(epoch)`` (native or numpy, chosen
    as the loader chooses), what ``DeviceDataPipeline`` uploads for a
    single-seed run of ``s``."""
    loader = TrainLoader((np.zeros((n, 1), np.float32),
                          np.zeros(n, np.int32)), 1, prefetch=0)
    perms = []
    for s in seeds:
        loader.reseed(int(s))
        perms.append(np.asarray(loader._perm(epoch), np.int64))
    return torch.from_numpy(np.stack(perms)).to(device)


# --- Per-replica schedule rotation (restart variants as [S] inputs) ---
#
# The sequential Trainer rotates bootstrap-schedule variants across restart
# attempts (trainer.DEFAULT_RESTART_ROTATION). Every variant differs only in
# numeric knobs of three schedules, so each replica gets its own variant as
# [S] knob tensors resolved by the same annealed_value:
#
#   z_pres_hold  grace window of the z_pres prior anneal (0 = reference)
#   spc_init     1.0 turns the scale-prior curriculum on (mean walks
#                0 -> -1; 0.0 leaves the constant default -1)
#   spc_hold     curriculum delay (usually = z_pres_hold)
#   temp_init    Concrete temperature anneal start (1.0 = the constant
#                reference temperature, 5.0 = soft-decisions anneal)

def rotation_knobs(z_pres_hold: float = 0.0, scale_curriculum: bool = False,
                   spc_hold: float | None = None, temp_init: float = 1.0):
    """One replica's schedule-knob dict (plain floats; stack for [S])."""
    return {
        "z_pres_hold": float(z_pres_hold),
        "spc_init": 1.0 if scale_curriculum else 0.0,
        "spc_hold": float(z_pres_hold if spc_hold is None else spc_hold),
        "temp_init": float(temp_init),
    }


N_ROTATION_VARIANTS = 5    # keep == len(variants) in vmap_rotation_variant


def rotation_variant_index(n_restarts: int) -> int:
    """Which rotation variant the n-th restart runs (n >= 1)."""
    return (n_restarts - 1) % N_ROTATION_VARIANTS


def vmap_rotation_variant(n: int, base_hold: float):
    """Knobs for the n-th restart (n >= 1): trainer.DEFAULT_RESTART_ROTATION
    variant (n-1) % 5."""
    variants = (
        rotation_knobs(0.0),                                  # reference
        rotation_knobs(base_hold, scale_curriculum=True,
                       spc_hold=0.0),                         # scale-prior
        rotation_knobs(base_hold, temp_init=5.0),             # temp anneal
        rotation_knobs(2 * base_hold, temp_init=5.0),         # long hold
        rotation_knobs(0.0, temp_init=5.0),                   # ref + temp
    )
    assert len(variants) == N_ROTATION_VARIANTS
    return variants[rotation_variant_index(n)]


def schedules_from_knobs(base_schedules: dict, knobs: dict) -> dict:
    """Annealing-schedules dict with the three rotation-controlled schedules
    rebuilt from ``knobs`` (floats, or [S] tensors)."""
    sched = dict(base_schedules)
    zp = dict(sched["z_pres_prior_log_odds"])
    zp["hold"] = knobs["z_pres_hold"]
    sched["z_pres_prior_log_odds"] = zp
    # spc_init=0 -> value 0, +offset -> the constant default mean of -1
    sched["scale_prior_mean"] = {
        "init": knobs["spc_init"], "min": 0.0, "factor": 0.5,
        "iters": 5000, "offset": -1.0, "hold": knobs["spc_hold"]}
    # temp_init=1 -> clamped at min 1.0 == the constant reference temp
    sched["z_pres_temperature"] = {
        "init": knobs["temp_init"], "min": 1.0, "factor": 0.5,
        "iters": 5000}
    return sched


def stack_knobs(knob_dicts):
    """[S] knob dicts -> dict of [S] float32 host tensors."""
    keys = knob_dicts[0].keys()
    return {k: torch.tensor([d[k] for d in knob_dicts], dtype=torch.float32)
            for k in keys}


def set_replica_knobs(knobs_S: dict, index: int, knobs: dict) -> dict:
    """``knobs_S`` with replica ``index``'s knobs replaced (a new dict)."""
    out = {k: v.clone() for k, v in knobs_S.items()}
    for k, v in out.items():
        v[index] = knobs[k]
    return out


def replica_hparams(config: AIRConfig, steps: torch.Tensor, knobs_S,
                    device) -> tuple[dict, dict]:
    """Each replica's annealable hyperparameters at its own clock ([S]
    ``steps``) and from its own knobs (or ``config.schedules``): the
    annealed ones as [S] float32 tensors on ``device`` (resolved on the
    host, one copy), the rest the config's static values. Returns them and
    their vmap ``in_dims``."""
    schedules = (config.schedules if knobs_S is None
                 else schedules_from_knobs(config.schedules, knobs_S))
    hp = resolve_annealed(schedules, config.annealable_defaults(), steps)
    names = [k for k, v in hp.items() if isinstance(v, torch.Tensor)]
    if names:
        rows = torch.stack([hp[k].expand(len(steps)) for k in names])
        hp.update(zip(names, rows.to(device, non_blocking=True)))
    return hp, {k: 0 if k in names else None for k in hp}


def replica_noise(config: AIRConfig, batch: int, seeds, steps,
                  device, out: dict | None = None) -> dict:
    """Every replica's draws of one train step, stacked [S, ...]: replica r
    draws from ``step_generator(seeds[r], steps[r])``, as the single-seed
    step of that seed and step does; into the [S, ...] tensors of ``out``
    when given."""
    draws = [draw_noise(config, batch, step_generator(seed, step, device),
                        device,
                        out=None if out is None else {k: v[r] for k, v in
                                                      out.items()})
             for r, (seed, step) in enumerate(zip(seeds, steps.tolist()))]
    if out is not None:
        return out
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def replica_host_scalars(config: AIRConfig, optimizer, steps: torch.Tensor,
                         opt_state, knobs_S=None) -> dict:
    """The host part of the seed-parallel step at each replica's clock
    ([S] ``steps``) and knobs: each hyperparameter the schedules anneal, as
    ``replica_hparams`` resolves it, and Adam's rows
    (``Optimizer.host_scalars_replicas``); {name: [S] float32 host
    tensor}."""
    schedules = (config.schedules if knobs_S is None
                 else schedules_from_knobs(config.schedules, knobs_S))
    hp = resolve_annealed(schedules, config.annealable_defaults(), steps)
    row = {name: hp[name].expand(len(steps)) for name in schedules}
    row.update(zip(REPLICA_SCALARS,
                   optimizer.host_scalars_replicas(opt_state)))
    return row


def _replica_grads(config: AIRConfig, params, images, targets, noise, hp,
                   hp_dims):
    """Every replica's forward pass under ``torch.func.vmap`` and the
    gradient of each replica's loss: (grads, {loss, accuracy,
    reconstruction_loss, kl_loss: [S]})."""
    def losses(params, images, targets, noise, hp):
        out = air_forward(params, config, images, targets, train=True,
                          hparams=hp, noise=noise)
        return (out.loss, out.accuracy, out.reconstruction_loss.mean(),
                out.kl_loss.mean())

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with no_vmap_fallback():
        loss, accuracy, recon, kl = vmap(
            losses, in_dims=(0, 0, 0, 0, hp_dims))(
                leaves, images, targets, noise, hp)
    if images.device.type == "cuda":
        _numeric_flags()  # the backward's products too
    grads = tree_unflatten(leaves, torch.autograd.grad(
        loss.sum(), tree_leaves(leaves)))
    return grads, {"loss": loss.detach(), "accuracy": accuracy,
                   "reconstruction_loss": recon.detach(),
                   "kl_loss": kl.detach()}


def replica_gradients(config: AIRConfig, state: TrainState, images,
                      targets, knobs_S=None, noise=None):
    """Every replica's forward pass on its own batch (``images`` [S, B, D],
    ``targets`` [S, B]) under ``torch.func.vmap``, at its own clock and
    knobs, with its own draws (``replica_noise``, or ``noise`` [S, ...]),
    and the gradient of each replica's loss. Returns (grads, metrics, hp):
    a tree of [S, ...] gradient leaves; loss, accuracy,
    reconstruction_loss and kl_loss, [S] each; the hyperparameters
    (``replica_hparams``)."""
    device = images.device
    hp, hp_dims = replica_hparams(config, state.step, knobs_S, device)
    if noise is None:
        noise = replica_noise(config, targets.shape[1], state.seed,
                              state.step, device)
    grads, metrics = _replica_grads(config, state.params, images, targets,
                                    noise, hp, hp_dims)
    return grads, metrics, hp


def make_replica_body(config: AIRConfig):
    """Returns ``body(params, mu, nu, images, targets, noise, scalars) ->
    (params, mu, nu, metrics)``: one seed-parallel train step on tensors
    only, the counterpart of ``steps.make_step_body``. Leaves lead with the
    replica axis [S]; ``scalars`` holds the rows of
    ``replica_host_scalars`` as [S] tensors on the device; metrics are
    [S] each (``steps.TRAIN_METRICS``). Nothing it is given is changed."""
    optimizer = make_optimizer(config)
    defaults = config.annealable_defaults()

    def body(params, mu, nu, images, targets, noise, scalars):
        hp = {**defaults, **{k: v for k, v in scalars.items()
                             if k in defaults}}
        hp_dims = {k: 0 if k in scalars else None for k in hp}
        grads, metrics = _replica_grads(config, params, images, targets,
                                        noise, hp, hp_dims)
        updates, new_mu, new_nu = optimizer.apply_replicas(grads, mu, nu,
                                                           scalars)
        log_odds = hp["z_pres_prior_log_odds"]
        if isinstance(log_odds, torch.Tensor):
            log_odds = log_odds.clone()
        else:
            log_odds = torch.full(targets.shape[:1], log_odds,
                                  dtype=torch.float32, device=images.device)
        metrics.update(grad_norm=global_norm_replicas(grads),
                       z_pres_prior_log_odds=log_odds)
        return apply_updates(params, updates), new_mu, new_nu, metrics

    return body


def make_replica_step(config: AIRConfig, knob_schedules: bool = False):
    """Returns ``step(state_S, images, targets, knobs_S=None, noise=None) ->
    (state_S, metrics)``: one seed-parallel train step on every replica's
    own batch (``images`` [S, B, D], ``targets`` [S, B]), run eagerly: the
    host part (``replica_host_scalars``, one copy to the device; the draws,
    ``replica_noise``, or ``noise`` [S, ...]) and the body
    (``make_replica_body``). Metrics are [S] each. ``state_S`` is left
    unchanged. The eager form of ``make_multi_seed_step``'s step."""
    optimizer = make_optimizer(config)
    body = make_replica_body(config)

    def step(state: TrainState, images, targets, knobs_S=None, noise=None):
        _check_knobs(knob_schedules, knobs_S)
        device = images.device
        row = replica_host_scalars(config, optimizer, state.step,
                                   state.opt_state, knobs_S)
        scalars = dict(zip(row, torch.stack(list(row.values())).to(
            device, non_blocking=True)))
        if noise is None:
            noise = replica_noise(config, targets.shape[1], state.seed,
                                  state.step, device)
        params, mu, nu, metrics = body(state.params, state.opt_state.mu,
                                       state.opt_state.nu, images, targets,
                                       noise, scalars)
        return state.replace(
            params=params, opt_state=optimizer.advance(state.opt_state, mu,
                                                       nu),
            step=state.step + 1), metrics

    return step


def replica_batch(images, digits, perms_S, index: int, batch_size: int,
                  out=None):
    """Batch ``index`` of every replica's epoch permutation of the shared
    ``images`` / ``digits``: [S, B, D] and [S, B], clamped to the last full
    batch as the single-seed loop's gather is; into the (images, digits)
    tensors ``out`` when given."""
    n, n_rep = images.shape[0], perms_S.shape[0]
    lo = min(index * batch_size, n - batch_size)
    rows = perms_S[:, lo:lo + batch_size].reshape(-1)
    if out is None:
        return (images.index_select(0, rows).reshape(n_rep, batch_size, -1),
                digits.index_select(0, rows).reshape(n_rep, batch_size))
    torch.index_select(images, 0, rows, out=out[0].view(len(rows), -1))
    torch.index_select(digits, 0, rows, out=out[1].view(-1))
    return out


def _check_knobs(knob_schedules: bool, knobs_S) -> None:
    if (knobs_S is not None) != knob_schedules:
        raise ValueError(f"built with knob_schedules={knob_schedules}, "
                         f"called with knobs_S "
                         f"{'set' if knobs_S is not None else 'None'}")


class MultiSeedStep(CapturedStep):
    """``make_multi_seed_step``'s step: one captured seed-parallel train
    step (``make_replica_body``), replayed once per step."""

    def __init__(self, config: AIRConfig, num_steps: int, batch_size: int,
                 knob_schedules: bool, pipeline_unroll: int = 1):
        check_unroll(pipeline_unroll)
        self.config, self.num_steps = config, num_steps
        self.batch_size, self.knob_schedules = batch_size, knob_schedules
        self.optimizer = make_optimizer(config)
        self.body = make_replica_body(config)
        self.metric_names = TRAIN_METRICS

    def __call__(self, state_S: TrainState, images, digits, perms_S, start,
                 knobs_S=None, noise=None, num_steps: int | None = None):
        _check_knobs(self.knob_schedules, knobs_S)
        config, b = self.config, self.batch_size
        k = self.num_steps if num_steps is None else num_steps
        start, n_rep = int(start), len(state_S.seed)
        device = images.device
        opt = state_S.opt_state
        rows = [replica_host_scalars(
            config, self.optimizer, state_S.step + i,
            opt._replace(count=opt.count + i, schedule_count=(
                None if opt.schedule_count is None
                else opt.schedule_count + i)), knobs_S) for i in range(k)]

        def fill(i, slots):
            replica_batch(images, digits, perms_S, start + i, b,
                          out=(slots.images, slots.targets))

        def draw(i, slots):
            if noise is not None:
                copy_noise(slots, noise[i])
            else:
                replica_noise(config, b, state_S.seed, state_S.step + i,
                              device, out=slots.noise)

        def new_slots():
            return SimpleNamespace(
                images=torch.empty((n_rep, b, images.shape[-1]),
                                   dtype=torch.float32, device=device),
                targets=torch.empty((n_rep, b), dtype=digits.dtype,
                                    device=device),
                noise={name: torch.empty((n_rep, *shape),
                                         dtype=torch.float32, device=device)
                       for name, shape in noise_shapes(config, b).items()})

        return self._run(state_S, {name: torch.stack([r[name] for r in rows])
                                   for name in rows[0]},
                         fill, draw, new_slots)


def make_multi_seed_step(config: AIRConfig, num_steps: int, batch_size: int,
                         knob_schedules: bool = False,
                         pipeline_unroll: int = 1) -> MultiSeedStep:
    """Returns ``multi(state_S, images, digits, perms_S, start,
    knobs_S=None, noise=None, num_steps=None) -> (state_S, metrics)``:
    ``num_steps`` train steps of every replica, step i of replica r on rows
    ``perms_S[r, lo:lo + B]``, ``lo = (start + i) * B``, of the shared
    device-resident ``images`` and ``digits`` (clamped to the last full
    batch, as the single-seed loop's gather). ``perms_S`` is [S, n], one
    epoch permutation per replica (``multi_seed_perms``); metrics come back
    as [K, S] tensors. A call's ``num_steps`` runs a shorter chunk through
    the same graph.

    The step is captured once as a CUDA graph and replayed once per step
    (``fast_pipeline.CapturedStep``); each replica's clock, knobs, Adam
    scalars and draws reach it through static slots. ``pipeline_unroll``
    must be an int >= 1 (else ``ValueError``) and leaves the one-step
    replays and their bits as ``make_multi_step`` does. The returned state
    aliases the step's buffers, which its next call overwrites: a caller
    that keeps a state across calls clones it. A state it did not return
    (a fresh one, ``reinit_replica``'s) is copied in and left unchanged.

    ``knob_schedules=True`` takes ``knobs_S`` (``stack_knobs``), each
    replica's bootstrap-schedule variant. ``noise``, K dicts of stacked
    [S, ...] draws, overrides the replicas' generators (the tests feed
    JAX's draws)."""
    return MultiSeedStep(config, num_steps, batch_size, knob_schedules,
                         pipeline_unroll)


def make_multi_seed_eval(config: AIRConfig, knob_schedules: bool = False):
    """Per-replica eval: ``eval_fn(params_S, images, digits, key, steps_S,
    knobs_S=None) -> (accuracy [S], loss [S])`` over one test batch (chunk
    outside), device tensors. ``steps_S`` is per replica: each replica's
    annealed hyperparameters resolve at its own clock (and, with
    ``knob_schedules``, from its own ``knobs_S``). ``key`` is the ``(seed,
    step)`` of the draws, shared by every replica (``step_generator``)."""

    def one(params, images, digits, noise, hp):
        out = air_forward(params, config, images, digits, train=False,
                          hparams=hp, noise=noise)
        return out.accuracy, out.per_example_loss.mean()

    def eval_fn(params_S, images, digits, key, steps_S, knobs_S=None):
        _check_knobs(knob_schedules, knobs_S)
        device = images.device
        hp, hp_dims = replica_hparams(config, steps_S, knobs_S, device)
        noise = draw_noise(config, images.shape[0],
                           step_generator(*key, device), device)
        with torch.no_grad(), no_vmap_fallback():
            return vmap(one, in_dims=(0, None, None, None, hp_dims))(
                params_S, images, digits, noise, hp)

    eval_fn.knob_schedules = knob_schedules
    return eval_fn


def evaluate_replicas(config: AIRConfig, state: TrainState, images, digits,
                      key, step=None, batch_size: int = 500, eval_fn=None,
                      knobs_S=None):
    """Test-set accuracy and loss of every replica, in chunks of
    ``batch_size`` (the tail chunk smaller): (accuracy [S], loss [S]) numpy
    arrays, each the chunks' mean weighted by their sizes.

    The annealed hyperparameters resolve at each replica's own clock
    (``step=None``) or at a shared ``step``, and from each replica's own
    ``knobs_S`` when given. ``key``: the (seed, step) of the draws."""
    if eval_fn is None:
        eval_fn = make_multi_seed_eval(config,
                                       knob_schedules=knobs_S is not None)
    elif eval_fn.knob_schedules != (knobs_S is not None):
        raise ValueError(
            f"eval_fn was built with knob_schedules={eval_fn.knob_schedules}"
            f" but knobs_S is {'set' if knobs_S is not None else 'None'}: "
            f"pass a matching pair (make_multi_seed_eval(config, "
            f"knob_schedules={knobs_S is not None}))")
    steps_S = (state.step if step is None
               else torch.full_like(state.step, int(step)))
    extra = () if knobs_S is None else (knobs_S,)
    device = _device(state)
    accs, losses, weights = [], [], []
    for lo in range(0, len(images), batch_size):
        chunk = torch.as_tensor(images[lo:lo + batch_size],
                                dtype=torch.float32, device=device)
        chunk_digits = torch.as_tensor(digits[lo:lo + batch_size],
                                       dtype=torch.int32, device=device)
        acc, loss = eval_fn(state.params, chunk, chunk_digits, key, steps_S,
                            *extra)
        accs.append(acc)
        losses.append(loss)
        weights.append(len(chunk))
    acc, loss = (torch.stack(v).cpu().numpy().astype(np.float64)
                 for v in (accs, losses))
    w = np.asarray(weights, np.float64)[:, None]
    return (acc * w).sum(0) / w.sum(), (loss * w).sum(0) / w.sum()
