"""Train state and the optimizer, to optax's semantics as the JAX package
composes them.

Counterpart of ``air_tpu/train/state.py``. ``make_optimizer`` chains, in
the JAX package's order:

  * ``freeze_background``: the ``background`` gradient set to zero first, so
    the frozen parameter neither moves nor enters the clip's norm;
  * ``clip_by_global_norm(gradient_clipping_norm)``: optax's
    ``select(norm < max, g, g / norm * max)``;
  * Adam: with ``adam_storage_dtype="bfloat16"`` the JAX package's
    ``scale_by_adam_stored`` (moments promoted to float32, updated,
    bias-corrected with ``b1**t`` and ``b2**t`` in float32, demoted to
    bfloat16 by round-to-nearest-even); otherwise ``optax.adam`` (float32
    moments, eps 1e-8, eps_root 0);
  * the step ``-lr``, where ``lr`` may follow a ``learning_rate`` annealing
    schedule of the schedule's own update count, as optax's
    ``scale_by_schedule`` counts.

Plain tensor ops, not ``torch.optim.Adam``, whose bias correction and eps
placement differ and which keeps float32 moments. The optimizer state keeps
optax's leaves (``count``, ``mu``, ``nu`` and the schedule's ``count``), so
checkpoints carry over both ways (``air_tpu_torch.interop``).

Seed-parallel training (``train/multi_seed.py``) keeps S replicas in one
stacked ``TrainState`` (``stack_train_states``): every parameter and moment
leaf gains a leading ``[S]`` axis; ``step`` and Adam's counts are ``[S]``
int64 tensors on the host, one clock per replica (a re-seeded replica's
restarts at 0); ``seed`` is a list of S ints. ``Optimizer.update_replicas``
updates it with each replica's own bias corrections, step size and clip
norm, computed as ``update`` computes them, with no per-replica loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from air_tpu_torch.models.air import init_air_params
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import annealed_value
from air_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """Adam's state: the update count, the moments (a tree like the params,
    float32 or bfloat16) and, with a learning-rate schedule, the schedule's
    own count (``None`` without one). Counts are Python ints."""
    count: int
    mu: Any
    nu: Any
    schedule_count: int | None


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: int           # the reference's global_step
    seed: int           # per-step draws come from (seed, step)

    def replace(self, **kw) -> "TrainState":
        return self._replace(**kw)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32."""
    f32 = dict(dtype=torch.float32)
    return (1.0 - torch.pow(torch.tensor(decay, **f32),
                            torch.tensor(float(count), **f32))).item()


def bias_correction_replicas(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``_bias_correction`` of each replica: ``1 - decay**count`` in
    float32 for an [S] count, an [S] float32 tensor on the count's
    device."""
    f32 = dict(dtype=torch.float32, device=count.device)
    return 1.0 - torch.pow(torch.tensor(decay, **f32), count.to(**f32))


def global_norm(tree) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves, in leaf order, of each
    leaf's sum of squares."""
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """optax.clip_by_global_norm: ``g`` if the norm is below ``max_norm``,
    else ``(g / norm) * max_norm``."""
    norm = global_norm(tree)
    return tree_map(
        lambda g: torch.where(norm < max_norm, g, (g / norm) * max_norm),
        tree)


def global_norm_replicas(tree) -> torch.Tensor:
    """``global_norm`` of each replica of a tree of [S, ...] leaves: [S],
    each leaf's per-replica sum of squares summed over leaves in leaf
    order."""
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum((g * g).reshape(g.shape[0], -1), dim=1)
    return torch.sqrt(total)


def _per_replica(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """An [S] tensor shaped to broadcast over the [S, ...] ``leaf``."""
    return v.reshape(-1, *([1] * (leaf.dim() - 1)))


def clip_by_global_norm_replicas(tree, max_norm: float):
    """``clip_by_global_norm`` of each replica, by its own norm."""
    norm = global_norm_replicas(tree)
    return tree_map(
        lambda g: torch.where(_per_replica(norm, g) < max_norm, g,
                              (g / _per_replica(norm, g)) * max_norm),
        tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The chain of ``make_optimizer``: ``init(params) -> AdamState`` and
    ``update(grads, state) -> (updates, AdamState)``."""
    learning_rate: float
    lr_schedule: dict | None
    clip_norm: float | None
    freeze_background: bool
    storage_dtype: torch.dtype

    def init(self, params) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.storage_dtype)
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params),
                         0 if self.lr_schedule is not None else None)

    def update(self, grads, state: AdamState):
        grads = self._frozen(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        count = state.count + 1
        c1, c2 = _bias_correction(B1, count), _bias_correction(B2, count)
        if self.lr_schedule is None:
            step_size = -_f32(self.learning_rate)
            schedule_count = None
        else:
            step_size = -annealed_value(self.lr_schedule,
                                        state.schedule_count).item()
            schedule_count = state.schedule_count + 1
        return self._adam(grads, state, count, c1, c2, step_size,
                          schedule_count)

    def update_replicas(self, grads, state: AdamState):
        """``update`` of S stacked replicas: [S, ...] gradient and moment
        leaves, ``state.count`` (and the schedule's count) [S] int64 host
        tensors. Each replica's bias corrections and step size are computed
        on the host in float32, as ``update`` computes them, and reach the
        device in one copy; each replica is clipped by its own norm."""
        grads = self._frozen(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm_replicas(grads, self.clip_norm)
        count = state.count + 1
        if self.lr_schedule is None:
            step_size = torch.full(count.shape, -_f32(self.learning_rate))
            schedule_count = None
        else:
            step_size = -annealed_value(self.lr_schedule,
                                        state.schedule_count)
            schedule_count = state.schedule_count + 1
        c1, c2, step_size = torch.stack([
            bias_correction_replicas(B1, count),
            bias_correction_replicas(B2, count),
            step_size]).to(tree_leaves(grads)[0].device, non_blocking=True)
        return self._adam(grads, state, count, c1, c2, step_size,
                          schedule_count)

    def _frozen(self, grads):
        """The ``background`` gradient zeroed under ``freeze_background``."""
        if not self.freeze_background:
            return grads
        return {k: torch.zeros_like(g) if k == "background" else g
                for k, g in grads.items()}

    def _adam(self, grads, state: AdamState, count, c1, c2, step_size,
              schedule_count):
        """Adam's moments and updates from the bias corrections and step
        size: floats, or [S] tensors of stacked replicas."""
        def scale(v, leaf):
            return v if isinstance(v, float) else _per_replica(v, leaf)

        new_mu, new_nu, updates = [], [], []
        for g, m, v in zip(tree_leaves(grads), tree_leaves(state.mu),
                           tree_leaves(state.nu)):
            # float32 math; bfloat16 moments are promoted on read
            mu = B1 * m.float() + (1.0 - B1) * g
            nu = B2 * v.float() + (1.0 - B2) * (g * g)
            u = (mu / scale(c1, g)) / (torch.sqrt(nu / scale(c2, g)) + EPS)
            updates.append(scale(step_size, g) * u)
            new_mu.append(mu.to(self.storage_dtype))
            new_nu.append(nu.to(self.storage_dtype))
        return (tree_unflatten(grads, updates),
                AdamState(count, tree_unflatten(grads, new_mu),
                          tree_unflatten(grads, new_nu), schedule_count))


def make_optimizer(config: AIRConfig) -> Optimizer:
    if config.freeze_background and not config.learn_background:
        raise ValueError("freeze_background requires learn_background")
    storage = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        config.adam_storage_dtype]
    return Optimizer(learning_rate=config.learning_rate,
                     lr_schedule=config.schedules.get("learning_rate"),
                     clip_norm=config.gradient_clipping_norm,
                     freeze_background=config.freeze_background,
                     storage_dtype=storage)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def create_train_state(config: AIRConfig, seed: int = 0, params=None,
                       background_init=None, device="cuda") -> TrainState:
    """The initial TrainState: ``params`` as given, or drawn by
    ``init_air_params`` from a generator on ``device`` seeded with ``seed``;
    a fresh optimizer state; step 0."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_air_params(gen, config, background_init)
    return TrainState(params=params,
                      opt_state=make_optimizer(config).init(params),
                      step=0, seed=seed)


def stack_train_states(states) -> TrainState:
    """S single-seed TrainStates as one stacked TrainState: params and
    moments stacked on a new leading axis, the steps and counts as [S]
    int64 host tensors, the seeds as a list."""
    opts = [st.opt_state for st in states]

    def clock(values):
        return torch.tensor([int(v) for v in values], dtype=torch.int64)

    def stack(trees):
        return tree_map(lambda *xs: torch.stack(xs), *trees)

    schedule_count = (None if opts[0].schedule_count is None
                      else clock(o.schedule_count for o in opts))
    return TrainState(
        params=stack([st.params for st in states]),
        opt_state=AdamState(clock(o.count for o in opts),
                            stack([o.mu for o in opts]),
                            stack([o.nu for o in opts]), schedule_count),
        step=clock(st.step for st in states),
        seed=[int(st.seed) for st in states])
