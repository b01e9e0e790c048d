"""Spatial transformer for axis-aligned thetas: the plain separable form.

Counterpart of the zeros-pad ("hat") path of ``air_tpu/ops/transformer.py``.
For ``theta = [[sx, 0, tx], [0, sy, ty]]`` bilinear resampling factors per
axis, so it is two batched products ``out = Wy @ im @ Wx^T`` with

    W[b, i, j] = relu(1 - |p_bi - j|),
    p_bi = (scale_b * t_i + shift_b + 1) * (in - 1.001) / 2,
    t = linspace(-1, 1, out).

These functions are the plain twin that the hand-written kernels of
``air_tpu_torch.kernels.st_inline`` are held against, and the path that
``st_impl="xla"`` takes.
"""

from __future__ import annotations

import torch


def _pixel_coords(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """Map normalized [-1, 1] coords to pixel space: (x + 1) * (dim - 1.001) / 2."""
    return (coords + 1.0) * ((dim - 1.001) / 2.0)


def _linspace(n: int, device) -> torch.Tensor:
    """``linspace(-1, 1, n)`` in float32 by ``jnp.linspace``'s formula:
    ``-1 * (1 - step) + 1 * step`` with ``step = i / (n - 1)``, and the end
    point exact. The CUDA kernels form the grid with the same roundings
    (``torch.linspace`` rounds some points one ulp apart). The divisor is a
    tensor on ``device``: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    step = torch.arange(n - 1, **f32) / torch.full((), n - 1, **f32)
    t = -(1.0 - step) + step
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def _axis_weight_matrix(scale: torch.Tensor, shift: torch.Tensor,
                        out_dim: int, in_dim: int,
                        pad_mode: str = "zeros") -> torch.Tensor:
    """Per-batch bilinear interpolation matrix [B, out_dim, in_dim] for one
    axis, with true zero padding outside the image."""
    if pad_mode != "zeros":
        raise NotImplementedError(
            f"pad_mode={pad_mode!r}: the port implements 'zeros' only")
    t = _linspace(out_dim, scale.device)                       # [out]
    src = scale[:, None] * t[None, :] + shift[:, None]         # [B, out]
    p = _pixel_coords(src, in_dim)
    j = torch.arange(in_dim, dtype=torch.float32, device=scale.device)
    return torch.clamp(1.0 - torch.abs(p[..., None] - j), min=0.0)


def separable_transform(images: torch.Tensor,
                        sx: torch.Tensor, sy: torch.Tensor,
                        tx: torch.Tensor, ty: torch.Tensor,
                        out_size: tuple[int, int],
                        pad_mode: str = "zeros") -> torch.Tensor:
    """Resample [B, H, W] images under theta = [[sx,0,tx],[0,sy,ty]]."""
    _, in_h, in_w = images.shape
    out_h, out_w = out_size
    wy = _axis_weight_matrix(sy, ty, out_h, in_h, pad_mode)  # [B, oh, ih]
    wx = _axis_weight_matrix(sx, tx, out_w, in_w, pad_mode)  # [B, ow, iw]
    return torch.bmm(torch.bmm(wy, images), wx.transpose(1, 2))


def attention_read(images: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, window_size: int,
                   pad_mode: str = "zeros") -> torch.Tensor:
    """Canvas -> attention window under theta [[s,0,x],[0,s,y]]."""
    return separable_transform(images, s, s, x, y,
                               (window_size, window_size), pad_mode)


def attention_write(windows: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor, canvas_size: int,
                    pad_mode: str = "zeros") -> torch.Tensor:
    """Window -> canvas under theta [[1/s,0,-x/s],[0,1/s,-y/s]]."""
    inv_s = 1.0 / s
    return separable_transform(windows, inv_s, inv_s, -x * inv_s, -y * inv_s,
                               (canvas_size, canvas_size), pad_mode)
