"""Tracing and profiling utilities.

Counterpart of ``air_tpu/utils/profiling.py``: named regions around steps
(``torch.profiler.record_function`` plus an NVTX range on the card), a
``torch.profiler`` trace written as a TensorBoard trace directory, a
steady-state step timer that keeps the first call (the capture of a CUDA
graph step) apart, and the FLOPs of a function from PyTorch's FLOP counter.
"""

from __future__ import annotations

import contextlib
import time

import torch

_active = None      # the trace start_profiler_trace began


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in the profiler's trace and, on the card, an NVTX
    range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def start_profiler_trace(log_dir: str):
    """Begin a torch.profiler trace (host, and the card's kernels when
    there is one) that ``stop_profiler_trace`` writes into ``log_dir`` as
    TensorBoard's profiler plugin reads it."""
    global _active
    if _active is not None:
        raise RuntimeError("a profiler trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _active = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _active.start()


def stop_profiler_trace():
    global _active
    profiler, _active = _active, None
    profiler.stop()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed region into ``log_dir``::

        with profile_trace("/tmp/trace"):
            for _ in range(20):
                state, m = multi_step(state, images, digits, perm, 0)
            torch.cuda.synchronize()
    """
    start_profiler_trace(log_dir)
    try:
        yield
    finally:
        stop_profiler_trace()


def compiled_cost_analysis(fn, *args) -> dict:
    """The FLOPs of ``fn(*args)`` as PyTorch's FLOP counter
    (``torch.utils.flop_counter.FlopCounterMode``) counts them, running
    ``fn`` once: ``{"flops": n}``. The JAX package's other keys (bytes
    accessed, optimal seconds) come from XLA's cost model and are absent
    here, as its docstring allows; ``{}`` when no counted operator ran."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    flops = counter.get_total_flops()
    return {"flops": float(flops)} if flops else {}


class StepTimer:
    """Wall-clock step statistics with the first ``warmup`` steps apart
    (a captured step's first call warms it up and captures it).

    Usage::

        timer = StepTimer(warmup=1)
        for batch in loader:
            with timer.step(batch_size):
                state, m = multi_step.step(state, *batch)
                torch.cuda.synchronize()
        print(timer.summary())
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: list[float] = []
        self.items: list[int] = []

    @contextlib.contextmanager
    def step(self, n_items: int = 1):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        self.items.append(n_items)

    def summary(self) -> dict:
        times = self.times[self.warmup:] or self.times
        items = self.items[self.warmup:] or self.items
        total = sum(times)
        return {
            "steps": len(times),
            "mean_step_ms": 1000.0 * total / max(len(times), 1),
            "items_per_sec": sum(items) / total if total else 0.0,
            "first_step_ms": 1000.0 * self.times[0] if self.times else 0.0,
        }
