"""Headless streaming demo: demo-style inference without a display.

The port's copy of ``air_tpu/tools/headless_demo.py``: pulls frames from a
source (test records or a random scribble generator), runs batched
``ModelWrapper`` inference, and streams one JSON line per frame with
digits, per-step boxes, latency and NLL.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def scribble_frames(canvas_size: int, n: int, seed: int = 0):
    """Random stroke images as a stand-in for interactive drawing."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img = np.zeros((canvas_size, canvas_size), np.float32)
        for _ in range(rng.integers(0, 3)):
            hi = max(canvas_size - 15, 7)
            x, y = rng.integers(min(5, hi - 1), hi, 2)
            for t in np.linspace(0, 2 * np.pi, 60):
                px = int(x + 5 * np.cos(t) + rng.normal(0, 0.3))
                py = int(y + 6 * np.sin(t) + rng.normal(0, 0.3))
                if 0 <= px < canvas_size and 0 <= py < canvas_size:
                    img[py, px] = 1.0
        yield img


def stream(wrapper, frames, batch_size: int = 1, out=sys.stdout,
           include_windows: bool = False):
    """Run demo-style inference over frames; emit one JSON line per frame.
    Returns aggregate stats (frames/sec, mean latency ms)."""
    buf, count, t_start = [], 0, time.perf_counter()
    latencies = []

    def flush():
        nonlocal count
        if not buf:
            return
        t0 = time.perf_counter()
        digits, positions, recons, windows, latents, losses = \
            wrapper.infer(buf)
        dt = (time.perf_counter() - t0) * 1000.0
        latencies.append(dt / len(buf))
        for i in range(len(buf)):
            rec = {
                "frame": count,
                "digits": int(digits[i]),
                "boxes": np.asarray(positions[i]).tolist(),
                "nll": float(losses[i]),
                "latency_ms": dt / len(buf),
            }
            if include_windows:
                rec["windows"] = np.asarray(windows[i]).tolist()
            out.write(json.dumps(rec) + "\n")
            count += 1
        buf.clear()

    for frame in frames:
        buf.append(frame)
        if len(buf) >= batch_size:
            flush()
    flush()
    wall = time.perf_counter() - t_start
    return {"frames": count, "frames_per_sec": count / wall,
            "mean_latency_ms": float(np.mean(latencies)) if latencies else 0.0}
