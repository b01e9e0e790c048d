"""The device mesh and the placement of the train state on it.

Counterpart of ``air_tpu/parallel/mesh.py``. A ``Mesh`` is ``data x
model`` ranks, one process and one device each; rank ``r`` sits at data
index ``r // model`` and model index ``r % model``, as the JAX package lays
its devices out (``reshape(n // model_axis, model_axis)``). Each rank holds
the process group of its data axis (the ranks of its model index) and of
its model axis (the ranks of its data index).

The placement rule is the JAX package's: a 2-D leaf whose last dim
divides by the model axis and is at least 4x it is column-sharded, every
other leaf replicated. The port's dense kernels are ``[in, out]`` as the
JAX package's are, so the same leaves shard: the LSTM gate kernel, the VAE
and head hidden kernels. Adam's moments follow their params.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from air_tpu_torch.models.air import init_air_params
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.parallel.collectives import gather_slices, take_slice
from air_tpu_torch.train.state import TrainState
from air_tpu_torch.tree import tree_leaves, tree_unflatten

MODEL = "model"      # the placement of a column-sharded leaf; None: replicated


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data x model`` ranks; ``rank`` is this process's global rank. The
    groups are None for a mesh made without a process group (its shapes
    and placements only: a collective on it raises)."""
    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(n_devices: int | None = None, model_axis: int = 1) -> Mesh:
    """The ``data x model_axis`` mesh of ``n_devices`` ranks (all ranks of
    the process group by default). Raises ``ValueError`` when they do not
    divide by ``model_axis`` or are not the process group's world. Every
    rank must call it, in the same order as its other group calls. Without
    a process group it gives the mesh's shapes and placements only."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else None
    n = n_devices if n_devices is not None else (world or 1)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis="
                         f"{model_axis}")
    data = n // model_axis
    if not started:
        return Mesh(data, model_axis)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{world}: start one rank per device")
    # torch.distributed needs every rank to create every group, in order
    data_groups = [dist.new_group([d * model_axis + k for d in range(data)])
                   for k in range(model_axis)]
    model_groups = [dist.new_group([d * model_axis + k
                                    for k in range(model_axis)])
                    for d in range(data)]
    rank = dist.get_rank()
    return Mesh(data, model_axis, rank, data_groups[rank % model_axis],
                model_groups[rank // model_axis])


def leaf_sharding(mesh: Mesh, leaf) -> str | None:
    """``MODEL`` for a leaf (of its full shape) that the model axis
    column-shards, else None (replicated)."""
    m = mesh.model
    shape = tuple(getattr(leaf, "shape", ()))
    if m > 1 and len(shape) == 2 and shape[-1] % m == 0 and shape[-1] >= 4 * m:
        return MODEL
    return None


def param_sharding(mesh: Mesh, params) -> list:
    """``leaf_sharding`` of each leaf of a full-shaped param tree, in leaf
    order; given an ``AIRConfig``, of its model's params (their shapes from
    an init on the CPU: a shard's shape alone does not tell a column slice
    from a narrower replicated leaf)."""
    if isinstance(params, AIRConfig):
        params = init_air_params(torch.Generator().manual_seed(0), params)
    return [leaf_sharding(mesh, leaf) for leaf in tree_leaves(params)]


def _state_map(fn, state: TrainState, placements: list) -> TrainState:
    """``fn(leaf, placement)`` over the params, mu and nu of ``state``."""
    def over(tree):
        return tree_unflatten(tree, [fn(t, p) for t, p in
                                     zip(tree_leaves(tree), placements)])
    opt = state.opt_state
    return state.replace(params=over(state.params),
                         opt_state=opt._replace(mu=over(opt.mu),
                                                nu=over(opt.nu)))


def shard_state(mesh: Mesh, state: TrainState) -> TrainState:
    """This rank's part of a full TrainState: the column slice of each
    column-sharded leaf of the params and of Adam's mu and nu."""
    return _state_map(
        lambda t, p: (t if p is None else
                      take_slice(t, mesh.model, mesh.model_rank).contiguous()),
        state, param_sharding(mesh, state.params))


def gather_state(mesh: Mesh, state: TrainState, config) -> TrainState:
    """The full TrainState from every model rank's part: each sharded leaf
    gathered over the model axis, exactly. Every rank of the model group
    takes part; a model axis of 1 returns ``state``."""
    if mesh.model == 1:
        return state
    return _state_map(
        lambda t, p: t if p is None else gather_slices(t, mesh, MODEL, -1),
        state, param_sharding(mesh, config))


def shard_batch(mesh: Mesh, images, targets) -> tuple:
    """This rank's rows of a global batch: rows ``[r * b, (r + 1) * b)``
    of ``b = B / data`` for data index ``r``, as tensors. Raises
    ``ValueError`` when B does not divide."""
    return (data_rows(torch.as_tensor(images), mesh),
            data_rows(torch.as_tensor(targets), mesh))


def data_rows(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's slice of ``dim`` of ``t`` over the data axis."""
    if t.shape[dim] % mesh.data:
        raise ValueError(f"global batch {t.shape[dim]} not divisible by "
                         f"data axis size {mesh.data}")
    return take_slice(t, mesh.data, mesh.data_rank, dim)
