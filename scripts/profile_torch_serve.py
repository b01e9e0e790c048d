#!/usr/bin/env python3
"""Where the time of the port's ModelWrapper.infer goes on a CUDA card.

    python3 scripts/profile_torch_serve.py      # from the repository root

Serves the committed fixture (air_tpu_torch/assets/serve_canvases.npz) with
the shipped CNN checkpoint through the inline kernels, then traces 10 infer
calls at each request size (1 and 64 canvases) with torch.profiler and
prints, per size: the wall time per call (with the profiler on), the device
busy share (summed device time of kernels and copies over that wall time),
the number of kernels and copies per call, and those that take the most
device time. Prints the card's name and power limit first. Needs a card;
writes nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu_torch.serve.model_wrapper import ModelWrapper  # noqa: E402
from air_tpu_torch.train.checkpoint import (  # noqa: E402
    checkpoint_arch, load_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
CALLS = 10


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    config = DEFAULT_TRAINING_CONFIG.replace(**checkpoint_arch(CKPT),
                                             st_impl="inline")
    wrapper = ModelWrapper(config, load_params(CKPT), device="cuda")
    with np.load(FIXTURE) as z:
        canvases = z["canvases"]

    for n in (1, 64):
        req = canvases[np.arange(n) % len(canvases)]
        for _ in range(3):
            wrapper.infer(req)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                wrapper.infer(req)
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side rows only: an operator's row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in rows)
        kernels = sum(e.count for e in rows)
        print(f"n={n}: wall {wall_us / CALLS / 1e3:.3f} ms/call, device busy "
              f"{device_us / CALLS / 1e3:.3f} ms/call "
              f"({100 * device_us / wall_us:.1f}% of wall), "
              f"{kernels / CALLS:.0f} kernels and copies per call", flush=True)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / CALLS:9.1f} us/call "
                  f"x{e.count // CALLS:<4d} {e.key[:90]}", flush=True)


if __name__ == "__main__":
    main()
