"""Reconstruction visualization grids.

Counterpart of ``air_tpu/train/visualize.py``: the reference's image
summary (reference air/air_model.py:211-267, 130-158), zoomed original |
thin white stripe | zoomed reconstruction, with per-step red/green/blue
attention boxes obtained by pushing a unit window frame through the
*backward* spatial transform. ``save_grid_png`` writes the PNG with
``zlib`` and ``struct``, so no imaging library is needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from air_tpu_torch.ops.transformer import separable_transform


def _zoom_nearest(images: torch.Tensor, zoom: int) -> torch.Tensor:
    """[B, H, W] -> [B, zoom*H, zoom*W]."""
    return images.repeat_interleave(zoom, dim=1).repeat_interleave(zoom,
                                                                   dim=2)


def _unit_frame(window_size: int, device=None) -> torch.Tensor:
    """A window-sized image with a 1-px border of ones — what
    tf.image.draw_bounding_boxes([[0,0,1,1]]) produces on zeros
    (reference air/air_model.py:238-247)."""
    frame = torch.zeros((window_size, window_size), dtype=torch.float32,
                        device=device)
    frame[0, :] = 1.0
    frame[-1, :] = 1.0
    frame[:, 0] = 1.0
    frame[:, -1] = 1.0
    return frame


def attention_boxes(st_back: torch.Tensor, window_size: int,
                    out_size: int) -> torch.Tensor:
    """Render per-step attention boxes on the (zoomed) canvas.

    st_back: [B, T, 2, 3] backward thetas. Returns [B, T, out, out] binary
    box masks (borders sharpened at > 0.01, reference air/air_model.py:253-259).
    """
    b, t = st_back.shape[:2]
    flat = st_back.reshape(b * t, 2, 3).to(torch.float32)
    frame = _unit_frame(window_size, flat.device).expand(
        b * t, window_size, window_size)
    boxes = separable_transform(frame, flat[:, 0, 0], flat[:, 1, 1],
                                flat[:, 0, 2], flat[:, 1, 2],
                                (out_size, out_size))
    boxes = torch.clamp(boxes, 0.0, 1.0)
    boxes = (boxes > 0.01).to(torch.float32)
    return boxes.reshape(b, t, out_size, out_size)


def draw_colored_bounding_boxes(images: torch.Tensor, boxes: torch.Tensor,
                                steps: torch.Tensor) -> torch.Tensor:
    """[B, H, W] gray + [B, T, H, W] boxes -> [B, H, W, 3] RGB with up to
    three step boxes in R, G, B (reference air/air_model.py:130-158)."""
    channels = [images, images, images]
    for s in range(min(3, boxes.shape[1])):
        step_box = boxes[:, s]
        active = (steps > s)[:, None, None]
        for c in range(3):
            if s == c:
                moved = torch.clamp(channels[c] + step_box, max=1.0)
            else:
                moved = torch.clamp(channels[c] - step_box, min=0.0)
            channels[c] = torch.where(active, moved, channels[c])
    return torch.stack(channels, dim=-1)


def visualize_reconstructions(original, reconstruction, st_back, steps,
                              canvas_size: int, window_size: int,
                              zoom: int = 2) -> np.ndarray:
    """[B, canvas^2] x2 + [B, T, 2, 3] + [B] -> [B, zH, 2*zW+4, 3] float grid
    (reference air/air_model.py:211-267), numpy."""
    st_back = torch.as_tensor(st_back)
    device = st_back.device
    original, reconstruction, steps = (
        torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=device)
        for x in (original, reconstruction, steps))
    b = original.shape[0]
    orig = _zoom_nearest(original.reshape(b, canvas_size, canvas_size), zoom)
    recon = _zoom_nearest(reconstruction.reshape(b, canvas_size, canvas_size),
                          zoom)
    boxes = attention_boxes(st_back, window_size, zoom * canvas_size)
    left = draw_colored_bounding_boxes(orig, boxes, steps)
    right = draw_colored_bounding_boxes(recon, boxes, steps)
    stripe = torch.ones((b, zoom * canvas_size, 4, 3), dtype=left.dtype,
                        device=device)
    return torch.cat([left, stripe, right], dim=2).cpu().numpy()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray):
    """An 8-bit PNG of ``pixels``: [H, W] uint8 grey (PIL's mode "L") or
    [H, W, 3] uint8 RGB, unfiltered rows, zlib level 6. Needs no PIL."""
    height, width = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),   # filter: none
                           pixels.reshape(height, width * channels)], axis=1)
    color_type = {1: 0, 3: 2}[channels]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                                8, color_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))
    return path


def save_grid_png(path: str, grid: np.ndarray, max_rows: int = 60):
    """Stack [B, H, W, 3] vertically into one 8-bit RGB PNG."""
    grid = np.clip(grid[:max_rows], 0.0, 1.0)
    stacked = (grid.reshape(-1, grid.shape[2], 3) * 255).astype(np.uint8)
    return write_png(path, stacked)
