"""Spatial-transformer attention read and write-accumulate with the bilinear
weights built inside the kernel (hand-written CUDA, ``csrc/st_inline.cu``).

Counterparts of ``air_tpu/kernels/st_inline.py``: ``inline_attention_read``
(TPU kernel ``_rd_fwd_kernel``) and ``inline_write_accumulate`` (TPU kernel
``_wr_fwd_kernel``), forward only; the backward kernels come with the
training slice.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it computes the plain PyTorch version beside it, which is built from
``air_tpu_torch.ops.transformer``. The wrappers raise on a dtype other than
float32, a shape the kernel does not take or tensors on different devices;
a strided input (the model passes column views such as ``shift[:, 0]``) is
copied to a contiguous one before the launch. Each kernel launch adds one
to ``LAUNCHES[<wrapper name>]``, and nothing else does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from air_tpu_torch.kernels import build
from air_tpu_torch.ops.transformer import attention_read, attention_write

LAUNCHES = {"inline_attention_read": 0, "inline_write_accumulate": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("st_inline").lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.st_inline_read.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.st_inline_read.restype = i32
    lib.st_inline_write.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.st_inline_write.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _launch(fn, device, *tensors_and_sizes) -> None:
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in tensors_and_sizes]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


# -------------------- plain versions ----------------------------------------

def attention_read_plain(images, s, x, y, window_size: int) -> torch.Tensor:
    """Plain PyTorch version of the read kernel: [B, cs, cs] -> [B, ws, ws]."""
    return attention_read(images, s, x, y, window_size)


def write_accumulate_plain(canvas, windows, s, x, y, coeff,
                           canvas_size: int) -> torch.Tensor:
    """Plain PyTorch version of the write kernel on [B, cs, cs] canvases."""
    return canvas + coeff[:, None, None] * attention_write(
        windows, s, x, y, canvas_size)


# -------------------- wrappers ----------------------------------------------

def inline_attention_read(images: torch.Tensor, s: torch.Tensor,
                          x: torch.Tensor, y: torch.Tensor,
                          window_size: int) -> torch.Tensor:
    """Canvas -> window under theta [[s,0,x],[0,s,y]]: [B, cs, cs] images ->
    [B, ws, ws] windows."""
    b, cs = images.shape[0], images.shape[-1]
    ws = window_size
    if b < 1 or cs < 2 or ws < 2:
        raise ValueError(f"read: needs B >= 1 and sizes >= 2, got B={b}, "
                         f"cs={cs}, ws={ws}")
    dev = images.device
    _check("images", images, (b, cs, cs), dev)
    for name, t in (("s", s), ("x", x), ("y", y)):
        _check(name, t, (b,), dev)
    if dev.type == "cpu":
        return attention_read_plain(images, s, x, y, ws)
    if dev.type != "cuda":
        raise ValueError(f"read: no kernel for device {dev}")
    # theta [[s, 0, x], [0, s, y]]: rows (y axis) use (s, y), columns (s, x)
    images, s, x, y = (t.contiguous() for t in (images, s, x, y))
    out = torch.empty((b, ws, ws), dtype=torch.float32, device=dev)
    _launch(_lib().st_inline_read, dev, images, s, y, s, x, out, b, cs, ws)
    LAUNCHES["inline_attention_read"] += 1
    return out


def inline_write_accumulate(canvas_flat: torch.Tensor, windows: torch.Tensor,
                            s: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            coeff: torch.Tensor,
                            canvas_size: int) -> torch.Tensor:
    """``canvas + coeff * attention_write(windows, s, x, y)``: [B, cs*cs]
    canvas and [B, ws*ws] (or [B, ws, ws]) windows -> a new [B, cs*cs]
    canvas. The input canvas is left unchanged."""
    b, cs = canvas_flat.shape[0], canvas_size
    ws = int(round((windows.numel() // max(b, 1)) ** 0.5))
    if b < 1 or cs < 2 or ws < 2:
        raise ValueError(f"write: needs B >= 1 and sizes >= 2, got B={b}, "
                         f"cs={cs}, ws={ws}")
    dev = canvas_flat.device
    _check("canvas", canvas_flat, (b, cs * cs), dev)
    if tuple(windows.shape) not in ((b, ws * ws), (b, ws, ws)):
        raise ValueError(f"windows: expected [{b}, {ws * ws}] or "
                         f"[{b}, {ws}, {ws}], got {tuple(windows.shape)}")
    _check("windows", windows.reshape(b, ws, ws), (b, ws, ws), dev)
    for name, t in (("s", s), ("x", x), ("y", y), ("coeff", coeff)):
        _check(name, t, (b,), dev)
    if dev.type == "cpu":
        return write_accumulate_plain(
            canvas_flat.reshape(b, cs, cs), windows.reshape(b, ws, ws),
            s, x, y, coeff, cs).reshape(b, cs * cs)
    if dev.type != "cuda":
        raise ValueError(f"write: no kernel for device {dev}")
    # window -> canvas theta [[1/s, 0, -x/s], [0, 1/s, -y/s]]
    inv_s = 1.0 / s
    ay, cy, ax, cx = inv_s, -y * inv_s, inv_s, -x * inv_s
    canvas_flat, windows, coeff = (t.contiguous()
                                   for t in (canvas_flat, windows, coeff))
    out = torch.empty_like(canvas_flat)
    _launch(_lib().st_inline_write, dev, canvas_flat, windows, ay, cy, ax, cx,
            coeff, out, b, cs, ws)
    LAUNCHES["inline_write_accumulate"] += 1
    return out
