"""ctypes bindings and the build on first use of the native loader
(``loader.cc``).

The port's copy of ``air_tpu/runtime/native.py``. The one change is where
the library goes: ``g++`` builds it into ``air_tpu_torch/_build/`` (kept
out of git), keyed by a hash of the source, not next to the source. The
permutation of ``(seed, epoch)`` is the JAX package's native one, so a run
resumed under either package sees the same data order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()
_lib = None


def build_native() -> str:
    """Compile loader.cc into ``_build/libairloader-<hash>.so`` unless that
    file exists; returns its path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    lib = os.path.join(_BUILD, f"libairloader-{tag}.so")
    with _lock:
        if os.path.exists(lib):
            return lib
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _SRC, "-o", tmp, "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
        return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.shuffle_perm.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p]
    lib.gather_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.gather_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return lib


class NativeShuffleLoader:
    """Deterministic permutations + parallel batch gathers in C++.

    Permutations are a function of (seed, epoch) only — same contract as the
    numpy path in air_tpu_torch.data.loader (different stream, equally
    deterministic), so (epoch, index) checkpointing still gives exact resume.
    """

    def __init__(self, images: np.ndarray, digits: np.ndarray,
                 batch_size: int, seed: int = 0, n_threads: int = 4):
        self.lib = _load()
        self.images = np.ascontiguousarray(images, np.float32)
        self.digits = np.ascontiguousarray(digits, np.int32)
        self.n, self.row_len = self.images.shape
        self.batch_size = batch_size
        self.seed = seed
        self.n_threads = n_threads

    def perm(self, epoch: int) -> np.ndarray:
        out = np.empty(self.n, np.int32)
        self.lib.shuffle_perm(
            ctypes.c_uint64(self.seed), ctypes.c_uint64(epoch),
            ctypes.c_int64(self.n), out.ctypes.data_as(ctypes.c_void_p))
        return out

    def gather(self, idx: np.ndarray):
        idx = np.ascontiguousarray(idx, np.int32)
        k = len(idx)
        imgs = np.empty((k, self.row_len), np.float32)
        digs = np.empty(k, np.int32)
        self.lib.gather_f32(
            self.images.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(self.row_len),
            idx.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(k),
            imgs.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(self.n_threads))
        self.lib.gather_i32(
            self.digits.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(k),
            digs.ctypes.data_as(ctypes.c_void_p))
        return imgs, digs
