"""Build the port's CUDA sources with nvcc, load them with ctypes, and
launch their kernels.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers and is compiled on
first use into a shared library under ``air_tpu_torch/_build/``. The file
name carries a hash of the sources and flags, so a stale library is never
loaded. Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``. The kernel modules share the checks
of their wrappers and the launch through ctypes (``check``, ``launch``),
and the ``vmap`` rule of their autograd Functions (``fold_replicas``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# the library of each csrc/<name>.cu
LIBRARIES = ("st_inline", "st_pallas", "st_fused")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# shared memory one block can have on an H100 (dynamic, after opting in)
MAX_SMEM_BYTES = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    ptxas_report: str     # nvcc's -Xptxas -v output: registers, shared memory
    build_seconds: float  # 0.0 when an up-to-date library was found


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load(name: str) -> Library:
    """Compile ``csrc/<name>.cu`` if no library of the current sources exists,
    then load it. Raises if nvcc fails."""
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}-{_digest()}.so"
    report = so.with_suffix(".ptxas.txt")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        report.write_text(proc.stderr)
        os.replace(tmp, so)
    return Library(ctypes.CDLL(str(so)), so, report.read_text(), seconds)


def load_all() -> dict:
    """Every library of ``LIBRARIES``, one nvcc per source, all started
    together: {name: Library}. A process that starts ranks calls it first,
    so that they find the libraries built."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(load, LIBRARIES)))


def check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Raise unless ``t`` is float32 of ``shape`` on ``device``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def check_scalars(device, b: int, **scalars) -> None:
    for name, t in scalars.items():
        check(name, t, (b,), device)


def check_write(canvas_flat: torch.Tensor, windows: torch.Tensor,
                canvas_size: int, **scalars) -> tuple:
    """(B, cs, ws) of a write-accumulate's [B, cs*cs] canvas and [B, ws*ws]
    (or [B, ws, ws]) windows, with its [B] scalars; raises on what the
    kernels do not take."""
    b, cs = canvas_flat.shape[0], canvas_size
    ws = int(round((windows.numel() // max(b, 1)) ** 0.5))
    if b < 1 or cs < 2 or ws < 2:
        raise ValueError(f"write: needs B >= 1 and sizes >= 2, got B={b}, "
                         f"cs={cs}, ws={ws}")
    dev = canvas_flat.device
    check("canvas", canvas_flat, (b, cs * cs), dev)
    if tuple(windows.shape) not in ((b, ws * ws), (b, ws, ws)):
        raise ValueError(f"windows: expected [{b}, {ws * ws}] or "
                         f"[{b}, {ws}, {ws}], got {tuple(windows.shape)}")
    check("windows", windows.reshape(b, ws, ws), (b, ws, ws), dev)
    check_scalars(dev, b, **scalars)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"write: no kernel for device {dev}")
    return b, cs, ws


def check_smem(name: str, n_floats: int) -> None:
    """Raise if a block's operands do not fit its shared memory."""
    if 4 * n_floats > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: needs {4 * n_floats} bytes of shared "
                         f"memory per block, the card has {MAX_SMEM_BYTES}")


def contiguous(*ts):
    return tuple(t.contiguous() for t in ts)


def fold_replicas(function, info, in_dims, *args):
    """The ``vmap`` rule of a kernel's ``torch.autograd.Function`` whose
    tensor inputs all lead with the image axis: every input is brought to
    ``[S, B, ...]`` (its vmapped dimension moved to the front, or an
    unbatched input expanded), folded to ``[S*B, ...]``, and
    ``function.apply`` runs once on the folded inputs, so each kernel
    launches once for all S replicas. The kernels compute per image from
    per-image scalars, so the fold computes what S separate calls would.
    Non-tensor inputs pass through. Returns the outputs unfolded to
    ``[S, B, ...]`` and their vmapped dimensions (0)."""
    n = info.batch_size
    folded = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            a = a.movedim(d, 0) if d is not None else a.expand(n, *a.shape)
            a = a.reshape(n * a.shape[1], *a.shape[2:])
        folded.append(a)
    out = function.apply(*folded)
    if isinstance(out, torch.Tensor):
        return out.reshape(n, -1, *out.shape[1:]), 0
    return (tuple(o.reshape(n, -1, *o.shape[1:]) for o in out),
            (0,) * len(out))


def launch(fn, device, *tensors_and_sizes) -> None:
    """Call a launcher with the tensors' pointers, the sizes and the current
    stream of ``device``; raise if the launch was refused."""
    if device.type != "cuda":
        raise ValueError(f"{fn.__name__}: no kernel for device {device}")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in tensors_and_sizes]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
