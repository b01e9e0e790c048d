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
else does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from air_tpu_torch.kernels import build
from air_tpu_torch.ops.transformer import _axis_weight_matrix

LAUNCHES = {"pallas_attention_read": 0, "pallas_attention_write": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("st_pallas").lib
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.st_fused_dots.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
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
    build.check_smem(name, ih * iw + oh * ih + ow * iw + oh * iw)
    wy, images, wx = build.contiguous(wy, images, wx)
    out = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    build.launch(_lib().st_fused_dots, dev, wy, images, wx, out, b, oh, ow,
                 ih, iw)
    LAUNCHES[name] += 1
    return out


class _FusedDots(torch.autograd.Function):
    """``Wy @ images @ Wx^T`` with the weight matrices as inputs; the
    counterpart of the ``custom_vjp`` op of ``_make_op``."""

    @staticmethod
    def forward(ctx, images, wy, wx, name: str):
        ctx.save_for_backward(images, wy, wx)
        return fused_dots(wy, images, wx, name)

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
