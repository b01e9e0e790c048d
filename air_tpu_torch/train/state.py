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

An update is a host part and a device part. ``host_scalars`` (and
``host_scalars_replicas``) computes the bias corrections and the step size
from the counts on the host; ``apply`` (and ``apply_replicas``) takes them
as floats or as 0-d (or [S]) tensors on the device, which a step replayed
as a CUDA graph reads from its slots (``train/fast_pipeline.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from air_tpu_torch.models.air import init_air_params
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import annealed_value
from air_tpu_torch.parallel.collectives import model_sum_
from air_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

B1, B2, EPS = 0.9, 0.999, 1e-8
# the rows of Optimizer.host_scalars_replicas
REPLICA_SCALARS = ("c1", "c2", "step_size")


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


def _f32_reciprocal(v: float) -> float:
    """``1 / v`` in float32 (``v`` a float32 value), as a Python float."""
    return torch.reciprocal(torch.tensor(v, dtype=torch.float32)).item()


def bias_correction_replicas(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``_bias_correction`` of each replica: ``1 - decay**count`` in
    float32 for an [S] count, an [S] float32 tensor on the count's
    device."""
    f32 = dict(dtype=torch.float32, device=count.device)
    return 1.0 - torch.pow(torch.tensor(decay, **f32), count.to(**f32))


def global_norm(tree, mesh=None, sharded=None) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves, in leaf order, of each
    leaf's sum of squares. ``sharded`` (with a ``mesh``) marks, in leaf
    order, the leaves that are column slices on the model axis: their sums
    of squares are summed over the model axis first, in one all-reduce."""
    squares = [torch.sum(g * g) for g in tree_leaves(tree)]
    if sharded is not None and any(sharded):
        at = [i for i, s in enumerate(sharded) if s]
        summed = model_sum_(torch.stack([squares[i] for i in at]), mesh)
        for j, i in enumerate(at):
            squares[i] = summed[j]
    total = 0
    for sq in squares:
        total = total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, norm=global_norm):
    """optax.clip_by_global_norm: ``g`` if the norm is below ``max_norm``,
    else ``(g / norm) * max_norm``; ``norm(tree)`` gives the norm."""
    norm = norm(tree)
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

    def host_scalars(self, state: AdamState) -> dict:
        """The host part of the update from ``state``: the bias
        corrections of the next count (``c1``, ``c2``), their float32
        reciprocals (``inv_c1``, ``inv_c2``) and the step size, Python
        floats that are float32 values."""
        count = state.count + 1
        c1, c2 = _bias_correction(B1, count), _bias_correction(B2, count)
        if self.lr_schedule is None:
            step_size = -_f32(self.learning_rate)
        else:
            step_size = -annealed_value(self.lr_schedule,
                                        state.schedule_count).item()
        return {"c1": c1, "c2": c2, "inv_c1": _f32_reciprocal(c1),
                "inv_c2": _f32_reciprocal(c2), "step_size": step_size}

    def host_scalars_replicas(self, state: AdamState) -> torch.Tensor:
        """``host_scalars`` of S stacked replicas, each computed as
        ``host_scalars`` computes it: a [3, S] float32 host tensor of the
        rows ``c1``, ``c2`` and ``step_size`` (REPLICA_SCALARS)."""
        count = state.count + 1
        if self.lr_schedule is None:
            step_size = torch.full(count.shape, -_f32(self.learning_rate))
        else:
            step_size = -annealed_value(self.lr_schedule,
                                        state.schedule_count)
        return torch.stack([bias_correction_replicas(B1, count),
                            bias_correction_replicas(B2, count), step_size])

    @staticmethod
    def advance(state: AdamState, mu, nu) -> AdamState:
        """The AdamState after one update: the counts (ints or [S] host
        tensors) one on, the new moments."""
        schedule_count = (None if state.schedule_count is None
                          else state.schedule_count + 1)
        return AdamState(state.count + 1, mu, nu, schedule_count)

    def update(self, grads, state: AdamState):
        updates, mu, nu = self.apply(grads, state.mu, state.nu,
                                     self.host_scalars(state))
        return updates, self.advance(state, mu, nu)

    def update_replicas(self, grads, state: AdamState):
        """``update`` of S stacked replicas: [S, ...] gradient and moment
        leaves, ``state.count`` (and the schedule's count) [S] int64 host
        tensors. Each replica's bias corrections and step size are computed
        on the host in float32, as ``update`` computes them, and reach the
        device in one copy; each replica is clipped by its own norm."""
        rows = self.host_scalars_replicas(state).to(
            tree_leaves(grads)[0].device, non_blocking=True)
        updates, mu, nu = self.apply_replicas(
            grads, state.mu, state.nu, dict(zip(REPLICA_SCALARS, rows)))
        return updates, self.advance(state, mu, nu)

    def apply(self, grads, mu, nu, scalars: dict, norm=global_norm):
        """The device part of ``update``: the freeze, the clip and Adam on
        the moment trees ``mu`` and ``nu``, from ``host_scalars`` (floats,
        or 0-d tensors on the device that hold them); the clip takes the
        norm ``norm(grads)`` (``global_norm`` of a model axis's shards
        under ``air_tpu_torch.parallel``). Returns (updates, mu, nu).

        PyTorch divides a tensor on the card by a host scalar as the
        product with the scalar's float32 reciprocal, and on the CPU
        truly; the bias corrections are applied so, by ``inv_c1`` and
        ``inv_c2`` on the card, whether they come as floats or as device
        tensors: a step with them in device slots keeps the bits of one
        that passes floats."""
        grads = self._frozen(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, norm)

        def unbias(m, name):
            if m.is_cuda:
                return m * scalars["inv_" + name]
            return m / scalars[name]

        return self._adam(grads, mu, nu, unbias,
                          lambda g: scalars["step_size"])

    def apply_replicas(self, grads, mu, nu, scalars: dict):
        """``apply`` of S stacked replicas, from [S] device tensors ``c1``,
        ``c2`` and ``step_size`` (``host_scalars_replicas``); each replica
        is clipped by its own norm."""
        grads = self._frozen(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm_replicas(grads, self.clip_norm)

        def unbias(m, name):
            return m / _per_replica(scalars[name], m)

        return self._adam(grads, mu, nu, unbias,
                          lambda g: _per_replica(scalars["step_size"], g))

    def _frozen(self, grads):
        """The ``background`` gradient zeroed under ``freeze_background``."""
        if not self.freeze_background:
            return grads
        return {k: torch.zeros_like(g) if k == "background" else g
                for k, g in grads.items()}

    def _adam(self, grads, mu_tree, nu_tree, unbias, step_size):
        """Adam's updates and moments: ``unbias(moment, "c1" or "c2")``
        divides by a bias correction, ``step_size(leaf)`` is the step size
        shaped for a gradient leaf."""
        new_mu, new_nu, updates = [], [], []
        for g, m, v in zip(tree_leaves(grads), tree_leaves(mu_tree),
                           tree_leaves(nu_tree)):
            # float32 math; bfloat16 moments are promoted on read
            mu = B1 * m.float() + (1.0 - B1) * g
            nu = B2 * v.float() + (1.0 - B2) * (g * g)
            u = unbias(mu, "c1") / (torch.sqrt(unbias(nu, "c2")) + EPS)
            updates.append(step_size(g) * u)
            new_mu.append(mu.to(self.storage_dtype))
            new_nu.append(nu.to(self.storage_dtype))
        return (tree_unflatten(grads, updates),
                tree_unflatten(grads, new_mu), tree_unflatten(grads, new_nu))


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
