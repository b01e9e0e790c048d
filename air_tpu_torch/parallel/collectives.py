"""The collectives of multi-device training, and the two column-parallel
autograd Functions of the model axis.

A column-sharded dense kernel ``[in, out / m]`` on each of the m ranks of
a model group computes its column slice of ``x @ w``; the layers
(``nn/layers.py``, ``nn/lstm.py``) wrap that product as
``gather_from_model(copy_to_model(x) @ w)``:

  * ``copy_to_model``: the identity forward; its backward sums the
    model group's ``dx``, each rank's being the part through its columns;
  * ``gather_from_model``: the forward concatenates the ranks' column
    slices; the backward keeps this rank's slice of ``dy`` and does not
    sum, because everything downstream runs replicated on every model rank.

Only ``all_reduce`` and ``broadcast`` are used (gloo takes CUDA tensors for
those two alone). A gather is an all-reduce of a zero-filled buffer that
holds this rank's slice, which gives the slices' exact bits. Collectives of
tensors other than float32 run on a float32 copy (exact for bfloat16).

The model axis reaches the layers through ``model_axis(mesh)``, a context
around the forward pass; a sharded kernel met outside it raises.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_MODEL_MESH = contextvars.ContextVar("model_mesh", default=None)


def _group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` ("data" or "model") for
    this rank; raises for a mesh made without a process group."""
    group = getattr(mesh, f"{axis}_group")
    if group is None:
        raise RuntimeError(
            f"the mesh {mesh.shape} has no process groups: make it with "
            "make_mesh in a rank started by air_tpu_torch.parallel.launch")
    return group


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (through a float32 copy for other
    dtypes); returns ``t``."""
    if t.dtype == torch.float32 or t.dtype == torch.int32:
        dist.all_reduce(t, group=group)
        return t
    f = t.float()
    dist.all_reduce(f, group=group)
    return t.copy_(f)


def data_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the data axis in place."""
    return all_reduce_(t, _group(mesh, "data"))


def model_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the model axis in place."""
    return all_reduce_(t, _group(mesh, "model"))


def gather_slices(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ``axis`` group's slices of ``dim`` concatenated in rank order,
    exactly: each rank's ``t`` placed at its offset in a zero buffer, the
    buffers summed."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    k = mesh.data_rank if axis == "data" else mesh.model_rank
    dim = dim % t.dim()
    c = t.shape[dim]
    shape = (*t.shape[:dim], c * n, *t.shape[dim + 1:])
    full = t.new_zeros(shape)
    full.narrow(dim, k * c, c).copy_(t)
    return all_reduce_(full, _group(mesh, axis))


def take_slice(t: torch.Tensor, n: int, k: int, dim: int = -1):
    """Slice ``k`` of ``n`` equal slices of ``t`` along ``dim``."""
    c = t.shape[dim] // n
    return t.narrow(dim, k * c, c)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return model_sum_(dx.contiguous().clone(), ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return gather_slices(y.contiguous(), mesh, "model", -1)

    @staticmethod
    def backward(ctx, dy):
        mesh = ctx.mesh
        return (take_slice(dy, mesh.model, mesh.model_rank).contiguous(),
                None)


@contextlib.contextmanager
def model_axis(mesh):
    """Run the forward passes inside on ``mesh``'s model axis: a
    column-sharded kernel computes its slice and gathers it. A mesh of
    model axis 1 (or None) leaves every product as it is."""
    if mesh is not None and mesh.model > 1:
        _group(mesh, "model")
    else:
        mesh = None
    token = _MODEL_MESH.set(mesh)
    try:
        yield
    finally:
        _MODEL_MESH.reset(token)


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    out_dim: int) -> torch.Tensor:
    """``x @ w_full`` (``out_dim`` columns) from this rank's column slice
    ``w`` of the kernel, gathered over the model axis of the enclosing
    ``model_axis``. Raises unless ``w`` holds exactly ``out_dim / model``
    columns: a kernel of another width is a shape error, not a shard."""
    mesh = _MODEL_MESH.get()
    if mesh is None:
        raise RuntimeError(
            f"a kernel {tuple(w.shape)} for {out_dim} columns outside a "
            "model axis: run the forward of column-sharded params under "
            "parallel.collectives.model_axis(mesh)")
    if w.shape[-1] * mesh.model != out_dim:
        raise ValueError(
            f"a kernel {tuple(w.shape)} for {out_dim} columns is neither "
            f"whole nor a column slice of a model axis of {mesh.model}")
    return _GatherFromModel.apply(_CopyToModel.apply(x, mesh) @ w, mesh)


def broadcast_object(value):
    """``value`` of global rank 0 on every rank (the world group)."""
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]
