"""Spatial-transformer resample with the dense bilinear weight matrices
streamed into one hand-written CUDA kernel (``csrc/st_pallas.cu``).

Counterpart of ``air_tpu/kernels/st_pallas.py``: ``pallas_attention_read``
and ``pallas_attention_write`` (TPU kernel ``_fused_dots_kernel``). As
``_resample_pallas`` does, each builds the per-axis weight matrices ``Wy``
and ``Wx`` outside the kernel, here with the differentiable
``air_tpu_torch.ops.transformer._axis_weight_matrix``, and one
``torch.autograd.Function`` over ``(images, Wy, Wx)`` runs the kernel
``out = Wy @ images @ Wx^T``. Its backward is plain products (the JAX
package takes XLA's VJP there, outside any kernel), and the gradients of
``(s, x, y)`` flow through the weights' construction by autograd.

On CUDA tensors the Function launches the kernel or raises; on CPU tensors
it computes the plain version ``fused_dots_plain``. The wrappers raise on a
dtype other than float32, a shape the kernel does not take or tensors on
different devices. Each launch adds one to ``LAUNCHES[<direction>]``
(``"pallas_attention_read"`` or ``"pallas_attention_write"``), and nothing
else does but the replay of a captured train step, which adds the launches
its capture counted (``train/fast_pipeline.StepGraph``).

``geometry`` computes how a launch splits the work (``csrc/st_resample.cuh``,
shared with the write-accumulate forward of ``st_fused``): row groups per
image, rows per group, threads, shared-memory bytes per block and whether
every staged range takes the 16-byte bulk copies; the launcher checks what
it is given and the CPU tests reach it here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from air_tpu_torch.kernels import build
from air_tpu_torch.ops.transformer import _axis_weight_matrix

LAUNCHES = {"pallas_attention_read": 0, "pallas_attention_write": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# launch geometry, as csrc/st_resample.cuh takes it
SMS = 132                 # streaming multiprocessors of an H100 SXM
FILL_BLOCKS = SMS         # blocks a launch aims for, where the rows allow
MAX_HALF = 8              # rows per group at most 2 * MAX_HALF
MAX_THREADS = 256         # the kernels' __launch_bounds__
TILE_COLS = 4             # columns of a thread's register tile (kTileCols)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of a streamed-weight resample kernel: ``groups`` groups of
    ``rows`` consecutive output rows per image (the last may have fewer), one
    block of ``threads`` threads and ``smem_bytes`` of shared memory per
    group; ``bulk`` when every staged range is a multiple of 16 bytes at a
    16-byte offset, so that 1-D bulk copies bring it in (the wrapper also
    needs 16-byte aligned pointers for that path)."""
    groups: int
    rows: int
    threads: int
    smem_bytes: int
    bulk: bool


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _smem_floats(rows: int, ow: int, ih: int, iw: int, canvas: bool) -> int:
    """Floats of one block's shared memory, as st_resample.cuh's Layout: X,
    rows of Wy, Wx, Wx^T at an odd row stride, tmp at an odd row stride and,
    for the write-accumulate, the canvas rows; each region on 16 bytes."""
    n = (_round4(ih * iw) + _round4(rows * ih) + _round4(ow * iw)
         + _round4(iw * (ow | 1)) + _round4(rows * (iw | 1)))
    return n + (_round4(rows * ow) if canvas else 0)


def geometry(batch: int, oh: int, ow: int, ih: int, iw: int,
             canvas: bool = False, name: str = "fused_dots") -> Geometry:
    """How a launch of ``out = Wy @ X @ Wx^T`` (Wy [B, oh, ih], X [B, ih, iw],
    Wx [B, ow, iw]; with ``canvas`` the write-accumulate of [B, oh, ow]
    canvases) splits its work. A thread's tile is rows p and p + half by
    TILE_COLS columns, so ``rows`` is 2 * half. The largest half that still
    gives FILL_BLOCKS blocks, one per SM, where the rows allow (more, smaller
    blocks stage each image more often and measured slower on the card,
    PERF.md), and at most h_max: half <= MAX_HALF, the threads within
    MAX_THREADS, and a warp's rows of Wy (stride ih) in distinct
    shared-memory banks (half <= 32 / gcd(ih, 32)); then the rows are spread
    evenly over that many groups. Raises if a block does not fit."""
    q = max(-(-iw // TILE_COLS), -(-ow // TILE_COLS))
    h_max = max(1, min(MAX_HALF, 32 // math.gcd(ih, 32), MAX_THREADS // q))
    want = -(-FILL_BLOCKS // batch)
    half = h_max
    while half > 1 and -(-oh // (2 * half)) < want:
        half -= 1
    groups = -(-oh // (2 * half))
    half = -(-(-(-oh // groups)) // 2)
    rows = 2 * half
    threads = 32 * -(-(half * q) // 32)
    if threads > MAX_THREADS:
        raise ValueError(f"{name}: needs {threads} threads per block for "
                         f"widths {iw} and {ow}, the kernel takes "
                         f"{MAX_THREADS}")
    floats = _smem_floats(rows, ow, ih, iw, canvas)
    build.check_smem(name, floats)
    sizes = [ih * iw, rows * ih, oh * ih, ow * iw]
    if canvas:
        sizes += [rows * ow, oh * ow]
    return Geometry(groups, rows, threads, 4 * floats,
                    all(n % 4 == 0 for n in sizes))


def bulk_ok(geo: Geometry, *tensors: torch.Tensor) -> int:
    """1 when the launch takes the bulk-copy path: sizes and pointers on
    16 bytes."""
    return int(geo.bulk and all(t.data_ptr() % 16 == 0 for t in tensors))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("st_pallas").lib
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.st_fused_dots.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                  + [ctypes.c_void_p])
    lib.st_fused_dots.restype = ctypes.c_int
    return lib


def fused_dots_plain(wy: torch.Tensor, images: torch.Tensor,
                     wx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``Wy @ images @ Wx^T``,
    [B, oh, ih] x [B, ih, iw] x [B, ow, iw]^T -> [B, oh, ow]."""
    return torch.bmm(torch.bmm(wy, images), wx.transpose(1, 2))


def fused_dots(wy: torch.Tensor, images: torch.Tensor, wx: torch.Tensor,
               name: str) -> torch.Tensor:
    """``Wy @ images @ Wx^T``: the kernel on CUDA tensors, counted under
    ``LAUNCHES[name]``; its plain version on CPU tensors."""
    b, ih, iw = images.shape
    oh, ow = wy.shape[1], wx.shape[1]
    dev = images.device
    build.check("images", images, (b, ih, iw), dev)
    build.check("Wy", wy, (b, oh, ih), dev)
    build.check("Wx", wx, (b, ow, iw), dev)
    if dev.type == "cpu":
        return fused_dots_plain(wy, images, wx)
    geo = geometry(b, oh, ow, ih, iw, name=name)
    wy, images, wx = build.contiguous(wy, images, wx)
    out = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    build.launch(_lib().st_fused_dots, dev, wy, images, wx, out, b, oh, ow,
                 ih, iw, geo.groups, geo.rows, geo.threads, geo.smem_bytes,
                 bulk_ok(geo, wy, images, wx))
    LAUNCHES[name] += 1
    return out


class _FusedDots(torch.autograd.Function):
    """``Wy @ images @ Wx^T`` with the weight matrices as inputs; the
    counterpart of the ``custom_vjp`` op of ``_make_op``. Under
    ``torch.func.vmap`` the replicas fold into the image axis and the kernel
    launches once (``build.fold_replicas``)."""

    @staticmethod
    def forward(images, wy, wx, name: str):
        return fused_dots(wy, images, wx, name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])

    @staticmethod
    def backward(ctx, g):
        images, wy, wx = ctx.saved_tensors
        need_img, need_wy, need_wx = ctx.needs_input_grad[:3]
        gwx = torch.bmm(g, wx)                                # [B, oh, iw]
        d_img = torch.bmm(wy.transpose(1, 2), gwx) if need_img else None
        d_wy = torch.bmm(gwx, images.transpose(1, 2)) if need_wy else None
        d_wx = (torch.bmm(g.transpose(1, 2), torch.bmm(wy, images))
                if need_wx else None)
        return d_img, d_wy, d_wx, None

    @staticmethod
    def vmap(info, in_dims, *args):
        return build.fold_replicas(_FusedDots, info, in_dims, *args)


def _resample(images, s, x, y, out_size: int, name: str, invert: bool):
    """``images`` [B, H, W] resampled to [B, out_size, out_size] under theta
    [[s, 0, x], [0, s, y]], or under its inverse [[1/s, 0, -x/s],
    [0, 1/s, -y/s]] when ``invert``; differentiable in every input."""
    if images.dim() != 3:
        raise ValueError(f"{name}: expected [B, H, W] images, got "
                         f"{tuple(images.shape)}")
    b, in_h, in_w = images.shape
    if b < 1 or min(in_h, in_w, out_size) < 2:
        raise ValueError(f"{name}: needs B >= 1 and sizes >= 2, got "
                         f"{tuple(images.shape)} -> {out_size}")
    dev = images.device
    build.check("images", images, (b, in_h, in_w), dev)
    build.check_scalars(dev, b, s=s, x=x, y=y)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    if invert:
        inv_s = 1.0 / s
        s, x, y = inv_s, -x * inv_s, -y * inv_s
    wy = _axis_weight_matrix(s, y, out_size, in_h)       # [B, out, in_h]
    wx = _axis_weight_matrix(s, x, out_size, in_w)       # [B, out, in_w]
    return _FusedDots.apply(images, wy, wx, name)


def pallas_attention_read(images: torch.Tensor, s: torch.Tensor,
                          x: torch.Tensor, y: torch.Tensor,
                          window_size: int) -> torch.Tensor:
    """Canvas -> window under theta [[s, 0, x], [0, s, y]]: [B, cs, cs]
    images -> [B, ws, ws] windows."""
    return _resample(images, s, x, y, window_size, "pallas_attention_read",
                     invert=False)


def pallas_attention_write(windows: torch.Tensor, s: torch.Tensor,
                           x: torch.Tensor, y: torch.Tensor,
                           canvas_size: int) -> torch.Tensor:
    """Window -> canvas under theta [[1/s, 0, -x/s], [0, 1/s, -y/s]]:
    [B, ws, ws] windows -> [B, cs, cs]."""
    return _resample(windows, s, x, y, canvas_size, "pallas_attention_write",
                     invert=True)
