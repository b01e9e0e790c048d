"""Spatial transformer ops: the separable form for axis-aligned thetas and
the general gather form.

Counterpart of ``air_tpu/ops/transformer.py``. For ``theta = [[sx, 0, tx],
[0, sy, ty]]`` bilinear resampling factors per axis, so it is two batched
products ``out = Wy @ im @ Wx^T`` with, under ``pad_mode="zeros"``,

    W[b, i, j] = relu(1 - |p_bi - j|),
    p_bi = (scale_b * t_i + shift_b + 1) * (in - 1.001) / 2,
    t = linspace(-1, 1, out).

``pad_mode="clamp_cancel"`` builds W from the reference's clamped corner
indices instead (``_corner_weights``): the same values except in the
one-pixel band outside the image, where it is 0, and no coordinate
gradient off the image. These functions are the plain twin that the
hand-written kernels of ``air_tpu_torch.kernels.st_inline`` are held
against (``"zeros"`` only), and the path that ``st_impl="xla"`` takes.

``transformer`` and ``batch_transformer`` resample ``[B, H, W, C]`` images
under any 2x3 theta (rotation, shear) by a four-corner gather with the
clamped corners, op for op the reference's spatial transformer.
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


def _corner_weights(p: torch.Tensor, dim: int):
    """The reference's CLAMPED floor and ceil corner indices of pixel
    coordinates ``p`` and their linear weights ``(lo, hi, w_lo, w_hi)``. A
    sample off the image clamps to ``lo == hi``, where ``w_lo + w_hi == 0``:
    zero padding whose derivative in ``p`` is zero too."""
    p0 = torch.floor(p).to(torch.int64)
    lo = torch.clamp(p0, 0, dim - 1)
    hi = torch.clamp(p0 + 1, 0, dim - 1)
    return lo, hi, hi.to(p.dtype) - p, p - lo.to(p.dtype)


def _axis_weight_matrix(scale: torch.Tensor, shift: torch.Tensor,
                        out_dim: int, in_dim: int,
                        pad_mode: str = "zeros") -> torch.Tensor:
    """Per-batch bilinear interpolation matrix [B, out_dim, in_dim] for one
    axis: the hat ``relu(1 - |p - j|)`` under ``"zeros"`` (true zero
    padding), ``one_hot(lo) * w_lo + one_hot(hi) * w_hi`` from the clamped
    corners under ``"clamp_cancel"``."""
    t = _linspace(out_dim, scale.device)                       # [out]
    src = scale[:, None] * t[None, :] + shift[:, None]         # [B, out]
    p = _pixel_coords(src, in_dim)
    j = torch.arange(in_dim, device=scale.device)
    if pad_mode == "clamp_cancel":
        lo, hi, w_lo, w_hi = _corner_weights(p, in_dim)
        return ((j == lo[..., None]).to(p.dtype) * w_lo[..., None]
                + (j == hi[..., None]).to(p.dtype) * w_hi[..., None])
    if pad_mode == "zeros":
        return torch.clamp(1.0 - torch.abs(p[..., None] - j.to(p.dtype)),
                           min=0.0)
    raise ValueError(f"unknown pad_mode: {pad_mode!r}")


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


def affine_grid(theta: torch.Tensor,
                out_size: tuple[int, int]) -> torch.Tensor:
    """The source sampling grid of 2x3 thetas: ``theta @ [x_t, y_t, 1]``
    over the ``linspace(-1, 1)`` grid of the output, [B, 2, out_h*out_w]
    (x then y)."""
    out_h, out_w = out_size
    device = theta.device
    y_t, x_t = torch.meshgrid(_linspace(out_h, device),
                              _linspace(out_w, device), indexing="ij")
    grid = torch.stack([x_t.reshape(-1), y_t.reshape(-1),
                        torch.ones(out_h * out_w, device=device)])  # [3, N]
    return theta.reshape(-1, 2, 3).to(grid.dtype) @ grid


def _bilinear_gather(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     out_size: tuple[int, int]) -> torch.Tensor:
    """Four-corner bilinear interpolation of [B, H, W, C] images at the
    normalised [B, N] points (x, y), the corners clamped
    (``_corner_weights``): [B, out_h, out_w, C]."""
    b, in_h, in_w, c = images.shape
    x0, x1, wx0, wx1 = _corner_weights(_pixel_coords(x, in_w), in_w)
    y0, y1, wy0, wy1 = _corner_weights(_pixel_coords(y, in_h), in_h)
    rows = torch.arange(b, device=images.device)[:, None]

    def gather(yi, xi):
        return images[rows, yi, xi]                             # [B, N, C]

    out = ((wx0 * wy0)[..., None] * gather(y0, x0)
           + (wx0 * wy1)[..., None] * gather(y1, x0)
           + (wx1 * wy0)[..., None] * gather(y0, x1)
           + (wx1 * wy1)[..., None] * gather(y1, x1))
    return out.reshape(b, *out_size, c)


def transformer(images: torch.Tensor, theta: torch.Tensor,
                out_size: tuple[int, int]) -> torch.Tensor:
    """General spatial transformer: [B, H, W, C] images under [B, 2, 3]
    (or [B, 6]) thetas -> [B, out_h, out_w, C]. Any affine theta; AIR's own
    path takes ``attention_read`` / ``attention_write``."""
    grid = affine_grid(theta, out_size)
    return _bilinear_gather(images, grid[:, 0], grid[:, 1], out_size)


def batch_transformer(images: torch.Tensor, thetas: torch.Tensor,
                      out_size: tuple[int, int]) -> torch.Tensor:
    """N thetas per image: [B, H, W, C] images and [B, N, 6] (or
    [B, N, 2, 3]) thetas -> [B*N, out_h, out_w, C], image-major."""
    b, n = thetas.shape[:2]
    return transformer(torch.repeat_interleave(images, n, dim=0),
                       thetas.reshape(b * n, 2, 3), out_size)
