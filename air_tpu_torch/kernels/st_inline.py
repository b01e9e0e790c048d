"""Spatial-transformer attention read and write-accumulate with the bilinear
weights built inside the kernel (hand-written CUDA, ``csrc/st_inline.cu``).

Counterparts of ``air_tpu/kernels/st_inline.py``: ``inline_attention_read``
(TPU kernels ``_rd_fwd_kernel`` and ``_rd_bwd_kernel``) and
``inline_write_accumulate`` (``_wr_fwd_kernel`` and ``_wr_bwd_kernel``).

Each pair of kernels sits behind one ``torch.autograd.Function`` that takes
the per-axis scalars ``(ay, cy, ax, cx)`` (and ``coeff`` for the write) as
tensor inputs, as ``_read_core`` and ``_write_core`` do in the JAX package.
The maps from ``(s, x, y)`` to those scalars stay plain differentiable torch
ops outside the Function, so autograd chains the scalar cotangents back.

On CUDA tensors the Function launches the forward kernel in ``forward`` and
the backward kernel in ``backward``, or raises; on CPU tensors it computes
the plain PyTorch versions beside them, all four in the same (a, c) form:
the forward ``attention_read_fwd_plain`` / ``write_accumulate_fwd_plain``
from ``air_tpu_torch.ops.transformer``'s weight matrices, the backward the
explicit formulas ``attention_read_bwd_plain`` / ``write_accumulate_bwd_plain``
(not autograd through the plain forward). The wrappers raise on a dtype
other than float32, a shape the kernel does not take or tensors on different
devices; a strided input (the model passes column views such as
``shift[:, 0]``) is copied to a contiguous one before the launch. Each
kernel launch adds one to ``LAUNCHES[<name>]``, and nothing else does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from air_tpu_torch.kernels import build
from air_tpu_torch.ops.transformer import (_axis_weight_matrix, _linspace,
                                           separable_transform)

LAUNCHES = {"inline_attention_read": 0, "inline_write_accumulate": 0,
            "inline_attention_read_bwd": 0, "inline_write_accumulate_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("st_inline").lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    for fn, n_ptr in ((lib.st_inline_read, 6), (lib.st_inline_write, 8),
                      (lib.st_inline_read_bwd, 11),
                      (lib.st_inline_write_bwd, 13)):
        fn.argtypes = [ptr] * n_ptr + [i32] * 3 + [ptr]
        fn.restype = i32
    return lib


# -------------------- plain versions ----------------------------------------

def attention_read_fwd_plain(images, ay, cy, ax, cx, ws: int):
    """Plain PyTorch version of the read kernel: ``Wy(ay, cy) @ images @
    Wx(ax, cx)^T``, [B, cs, cs] -> [B, ws, ws]."""
    return separable_transform(images, ax, ay, cx, cy, (ws, ws))


def write_accumulate_fwd_plain(canvas, windows, ay, cy, ax, cx, coeff):
    """Plain PyTorch version of the write kernel: ``canvas + coeff * (Wy(ay,
    cy) @ windows @ Wx(ax, cx)^T)`` on [B, cs, cs] canvases."""
    cs = canvas.shape[-1]
    return canvas + coeff[:, None, None] * separable_transform(
        windows, ax, ay, cx, cy, (cs, cs))


def _scalar_cotangents(dw, a, c, in_dim: int):
    """Contract a weight cotangent dW [B, out, in] of W(a, c) to (d_a, d_c):
    dp_i = sum_j dW[i, j] * -sign(p_i - j) * 1{|p_i - j| < 1},
    d_a = kpix * sum_i t_i dp_i, d_c = kpix * sum_i dp_i."""
    out_dim = dw.shape[1]
    kpix = (in_dim - 1.001) / 2.0
    t = _linspace(out_dim, dw.device)
    p = (a[:, None] * t + c[:, None] + 1.0) * kpix               # [B, out]
    d = p[..., None] - torch.arange(in_dim, dtype=torch.float32,
                                    device=dw.device)            # [B, out, in]
    dp = (dw * -torch.sign(d) * (torch.abs(d) < 1.0)).sum(-1)    # [B, out]
    return kpix * (t * dp).sum(-1), kpix * dp.sum(-1)


def attention_read_bwd_plain(images, g, ay, cy, ax, cx):
    """Plain PyTorch version of the read backward kernel: from images
    [B, cs, cs] and the output cotangent g [B, ws, ws], returns
    (d_images [B, cs, cs], d_ay, d_cy, d_ax, d_cx [B])."""
    ws, cs = g.shape[-1], images.shape[-1]
    wy = _axis_weight_matrix(ay, cy, ws, cs)             # [B, ws, cs]
    wx = _axis_weight_matrix(ax, cx, ws, cs)
    gwx = torch.bmm(g, wx)                               # [B, ws, cs]
    d_img = torch.bmm(wy.transpose(1, 2), gwx)
    dwy = torch.bmm(gwx, images.transpose(1, 2))         # [B, ws, cs]
    dwx = torch.bmm(g.transpose(1, 2), torch.bmm(wy, images))
    return (d_img, *_scalar_cotangents(dwy, ay, cy, cs),
            *_scalar_cotangents(dwx, ax, cx, cs))


def write_accumulate_bwd_plain(windows, g, ay, cy, ax, cx, coeff):
    """Plain PyTorch version of the write backward kernel: from windows
    [B, ws, ws] and the canvas cotangent g [B, cs, cs], returns
    (d_windows [B, ws, ws], d_ay, d_cy, d_ax, d_cx, d_coeff [B]).
    The canvas's own cotangent is g."""
    cs, ws = g.shape[-1], windows.shape[-1]
    c = coeff[:, None, None]
    wy = _axis_weight_matrix(ay, cy, cs, ws)             # [B, cs, ws]
    wx = _axis_weight_matrix(ax, cx, cs, ws)
    gwx = torch.bmm(g, wx)                               # [B, cs, ws]
    tmp = torch.bmm(wy, windows)                         # [B, cs, ws]
    d_win = c * torch.bmm(wy.transpose(1, 2), gwx)
    dwy = c * torch.bmm(gwx, windows.transpose(1, 2))
    dwx = c * torch.bmm(g.transpose(1, 2), tmp)
    recon = torch.bmm(tmp, wx.transpose(1, 2))
    return (d_win, *_scalar_cotangents(dwy, ay, cy, ws),
            *_scalar_cotangents(dwx, ax, cx, ws),
            (g * recon).sum((1, 2)))


# -------------------- kernels, or their plain versions on the CPU ------------

def attention_read_fwd(images, ay, cy, ax, cx, ws: int) -> torch.Tensor:
    """``Wy(ay, cy) @ images @ Wx(ax, cx)^T`` [B, ws, ws]: the read kernel on
    CUDA tensors, its plain version on CPU tensors."""
    b, cs = images.shape[0], images.shape[-1]
    if images.device.type == "cpu":
        return attention_read_fwd_plain(images, ay, cy, ax, cx, ws)
    images, ay, cy, ax, cx = build.contiguous(images, ay, cy, ax, cx)
    out = torch.empty((b, ws, ws), dtype=torch.float32, device=images.device)
    build.launch(_lib().st_inline_read, images.device, images, ay, cy, ax,
                 cx, out, b, cs, ws)
    LAUNCHES["inline_attention_read"] += 1
    return out


def attention_read_bwd(images, g, ay, cy, ax, cx):
    """(d_images, d_ay, d_cy, d_ax, d_cx) of the read: the backward kernel on
    CUDA tensors, ``attention_read_bwd_plain`` on CPU tensors."""
    b, cs, ws = images.shape[0], images.shape[-1], g.shape[-1]
    build.check("g", g, (b, ws, ws), images.device)
    if images.device.type == "cpu":
        return attention_read_bwd_plain(images, g, ay, cy, ax, cx)
    images, g, ay, cy, ax, cx = build.contiguous(images, g, ay, cy, ax, cx)
    d_img = torch.empty_like(images)
    d_s = torch.empty((4, b), dtype=torch.float32, device=images.device)
    build.launch(_lib().st_inline_read_bwd, images.device, images, g, ay,
                 cy, ax, cx, d_img, *d_s, b, cs, ws)
    LAUNCHES["inline_attention_read_bwd"] += 1
    return (d_img, *d_s)


def write_accumulate_fwd(canvas, windows, ay, cy, ax, cx, coeff):
    """``canvas + coeff * (Wy @ windows @ Wx^T)`` [B, cs, cs] as a new
    tensor: the write kernel on CUDA tensors, its plain version on CPU
    tensors."""
    b, cs, ws = canvas.shape[0], canvas.shape[-1], windows.shape[-1]
    if canvas.device.type == "cpu":
        return write_accumulate_fwd_plain(canvas, windows, ay, cy, ax, cx,
                                          coeff)
    canvas, windows, ay, cy, ax, cx, coeff = build.contiguous(
        canvas, windows, ay, cy, ax, cx, coeff)
    out = torch.empty_like(canvas)
    build.launch(_lib().st_inline_write, canvas.device, canvas, windows, ay,
                 cy, ax, cx, coeff, out, b, cs, ws)
    LAUNCHES["inline_write_accumulate"] += 1
    return out


def write_accumulate_bwd(windows, g, ay, cy, ax, cx, coeff):
    """(d_windows, d_ay, d_cy, d_ax, d_cx, d_coeff) of the write: the
    backward kernel on CUDA tensors, ``write_accumulate_bwd_plain`` on CPU
    tensors."""
    b, ws, cs = windows.shape[0], windows.shape[-1], g.shape[-1]
    build.check("g", g, (b, cs, cs), windows.device)
    if windows.device.type == "cpu":
        return write_accumulate_bwd_plain(windows, g, ay, cy, ax, cx, coeff)
    windows, g, ay, cy, ax, cx, coeff = build.contiguous(
        windows, g, ay, cy, ax, cx, coeff)
    d_win = torch.empty_like(windows)
    d_s = torch.empty((5, b), dtype=torch.float32, device=windows.device)
    build.launch(_lib().st_inline_write_bwd, windows.device, windows, g,
                 ay, cy, ax, cx, coeff, d_win, *d_s, b, cs, ws)
    LAUNCHES["inline_write_accumulate_bwd"] += 1
    return (d_win, *d_s)


class _ReadCore(torch.autograd.Function):
    """Read with the (a, c) scalars of each axis as inputs; counterpart of
    ``_read_core``."""

    @staticmethod
    def forward(ctx, images, ay, cy, ax, cx, ws: int):
        ctx.save_for_backward(images, ay, cy, ax, cx)
        return attention_read_fwd(images, ay, cy, ax, cx, ws)

    @staticmethod
    def backward(ctx, g):
        return (*attention_read_bwd(ctx.saved_tensors[0], g,
                                    *ctx.saved_tensors[1:]), None)


class _WriteCore(torch.autograd.Function):
    """Write-accumulate with the (a, c) scalars of each axis and ``coeff`` as
    inputs; counterpart of ``_write_core``. The canvas's cotangent is g."""

    @staticmethod
    def forward(ctx, canvas, windows, ay, cy, ax, cx, coeff):
        ctx.save_for_backward(windows, ay, cy, ax, cx, coeff)
        return write_accumulate_fwd(canvas, windows, ay, cy, ax, cx, coeff)

    @staticmethod
    def backward(ctx, g):
        return (g, *write_accumulate_bwd(ctx.saved_tensors[0], g,
                                         *ctx.saved_tensors[1:]))


# -------------------- wrappers ----------------------------------------------

def inline_attention_read(images: torch.Tensor, s: torch.Tensor,
                          x: torch.Tensor, y: torch.Tensor,
                          window_size: int) -> torch.Tensor:
    """Canvas -> window under theta [[s,0,x],[0,s,y]]: [B, cs, cs] images ->
    [B, ws, ws] windows, differentiable in every input."""
    b, cs = images.shape[0], images.shape[-1]
    ws = window_size
    if b < 1 or cs < 2 or ws < 2:
        raise ValueError(f"read: needs B >= 1 and sizes >= 2, got B={b}, "
                         f"cs={cs}, ws={ws}")
    dev = images.device
    build.check("images", images, (b, cs, cs), dev)
    build.check_scalars(dev, b, s=s, x=x, y=y)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"read: no kernel for device {dev}")
    # theta [[s, 0, x], [0, s, y]]: rows (y axis) use (s, y), columns (s, x)
    return _ReadCore.apply(images, s, y, s, x, ws)


def inline_write_accumulate(canvas_flat: torch.Tensor, windows: torch.Tensor,
                            s: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            coeff: torch.Tensor,
                            canvas_size: int) -> torch.Tensor:
    """``canvas + coeff * attention_write(windows, s, x, y)``: [B, cs*cs]
    canvas and [B, ws*ws] (or [B, ws, ws]) windows -> a new [B, cs*cs]
    canvas, differentiable in every input. The input canvas is left
    unchanged."""
    b, cs, ws = build.check_write(canvas_flat, windows, canvas_size, s=s,
                                  x=x, y=y, coeff=coeff)
    # window -> canvas theta [[1/s, 0, -x/s], [0, 1/s, -y/s]]
    inv_s = 1.0 / s
    out = _WriteCore.apply(canvas_flat.reshape(b, cs, cs),
                           windows.reshape(b, ws, ws), inv_s, -y * inv_s,
                           inv_s, -x * inv_s, coeff)
    return out.reshape(b, cs * cs)
