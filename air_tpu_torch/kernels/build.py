"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers and is compiled on
first use into a shared library under ``air_tpu_torch/_build/``. The file
name carries a hash of the sources and flags, so a stale library is never
loaded. Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
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
