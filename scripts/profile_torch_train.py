#!/usr/bin/env python3
"""Where the time of the port's train step goes on a CUDA card.

    python3 scripts/profile_torch_train.py      # from the repository root

Builds the full-width training state of DEFAULT_TRAINING_CONFIG with
cnn=True (create_train_state, seed 0), takes batches of 64 from the
committed fixture (air_tpu_torch/assets/serve_canvases.npz: the 60 canvases
and their first 4 again), and traces 10 train steps with torch.profiler for
each st_impl ("inline" and "pallas": the hand-written kernels forward and
backward; "xla": the plain PyTorch products). Prints, per st_impl: the
wall time per step with the profiler on, the device busy share (summed
device time of kernels and copies over that wall time), the kernels and
copies per step, the device time per step of the hand-written ST kernels
(csrc/*.cu: every kernel named st_*), and those that take the most device
time. Prints the card's name and power limit first. Needs a card; writes
nothing.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu_torch.train.state import create_train_state  # noqa: E402
from air_tpu_torch.train.steps import make_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
STEPS = 10
ST_KERNEL = re.compile(r"(?<![a-z])st_[a-z_]+?_kernel")   # csrc/*.cu kernels


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    with np.load(FIXTURE) as z:
        canvases, digits = z["canvases"], z["digits"]
    images = torch.from_numpy(np.concatenate([canvases, canvases[:4]])).cuda()
    targets = torch.from_numpy(np.concatenate([digits, digits[:4]])).cuda()

    for impl in ("inline", "pallas", "xla"):
        config = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl=impl)
        state = create_train_state(config, seed=0, device="cuda")
        step = make_train_step(config)
        for _ in range(3):
            state, _ = step(state, images, targets)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                state, _ = step(state, images, targets)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side rows only: an operator's row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in rows)
        kernels = sum(e.count for e in rows)
        print(f"st_impl={impl}: wall {wall_us / STEPS / 1e3:.3f} ms/step, "
              f"device busy {device_us / STEPS / 1e3:.3f} ms/step "
              f"({100 * device_us / wall_us:.1f}% of wall), "
              f"{kernels / STEPS:.0f} kernels and copies per step",
              flush=True)
        st = [e for e in rows if ST_KERNEL.search(e.key)]
        st_us = sum(e.self_device_time_total for e in st) / STEPS
        print(f"  ST kernels: {st_us:.1f} us/step over "
              f"{sum(e.count for e in st) / STEPS:.0f} launches; "
              + "; ".join(f"{ST_KERNEL.search(e.key)[0]} "
                          f"{e.self_device_time_total / STEPS:.1f} us x"
                          f"{e.count // STEPS}" for e in st), flush=True)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / STEPS:9.1f} us/step "
                  f"x{e.count // STEPS:<4d} {e.key[:90]}", flush=True)


if __name__ == "__main__":
    main()
