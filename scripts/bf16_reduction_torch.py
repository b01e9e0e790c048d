#!/usr/bin/env python3
"""What cuBLAS's bfloat16 reduced-precision reduction changes on the port's
bfloat16 path, on a CUDA card.

    python3 scripts/bf16_reduction_torch.py      # from the repository root

``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` (on
by PyTorch's default) lets cuBLAS sum the split-K partials of a bfloat16
product in bfloat16; the JAX package accumulates in float32, and the
port's numeric flags turn it off. For every bfloat16 product of the
full-width model (the LSTM, the five heads, the VAE's layers; forward
``A @ W`` and both backward products ``G @ W^T`` and ``A^T @ G``) at the
rows a train step gives it (batch 64 in the scan layout, 192 in the
step-parallel one) and a 1-canvas request gives it (1 and 3), it prints how
many output elements differ between the two settings, how many each
differs from the float32-accumulated product rounded once to bfloat16, and
the device time of each (CUDA events over 200 calls). Then one bfloat16
train step of each layout from one state and draws, in each setting: the
loss bits and the largest gradient difference. Prints the card's name and
power limit first. Needs a card; writes nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from air_tpu_torch.models.air import _numeric_flags, draw_noise  # noqa: E402
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu_torch.train.state import create_train_state  # noqa: E402
from air_tpu_torch.train.steps import (make_train_step,  # noqa: E402
                                       step_generator)
from air_tpu_torch.tree import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
# (name, K, N) of every bfloat16 product, at the default config with cnn
LAYERS = (("lstm", 1152 + 256, 1024), ("head.hidden", 256, 64),
          ("head.out", 64, 2), ("vae.rec0", 784, 512), ("vae.rec1", 512, 256),
          ("vae.mean", 256, 50), ("vae.gen0", 50, 256), ("vae.gen1", 256, 512),
          ("vae.out", 512, 784))
ROWS = (1, 3, 64, 192)


def set_reduction(on: bool) -> None:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on


def device_ms(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def products() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, k, n in LAYERS:
        for m in ROWS:
            a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).bfloat16()
            g = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
            for kind, x, y in (("fwd", a, w), ("dx", g, w.t()),
                               ("dw", a.t(), g)):
                ref = (x.float() @ y.float()).bfloat16()
                out, ms = {}, {}
                for on in (True, False):
                    set_reduction(on)
                    out[on] = x @ y
                    ms[on] = device_ms(lambda: x @ y)
                print(json.dumps({
                    "product": f"{name}.{kind}", "m": m, "shape": [
                        list(x.shape), list(y.shape)],
                    "elements": out[True].numel(),
                    "on_vs_off_differ": int((out[True] != out[False]).sum()),
                    "on_vs_fp32_acc_differ": int((out[True] != ref).sum()),
                    "off_vs_fp32_acc_differ": int((out[False] != ref).sum()),
                    "ms_on": ms[True], "ms_off": ms[False]}), flush=True)


def train_steps() -> None:
    with np.load(FIXTURE) as z:
        canvases, truth = z["canvases"], z["digits"]
    images = torch.from_numpy(np.concatenate([canvases, canvases[:4]])).cuda()
    digits = torch.from_numpy(np.concatenate([truth, truth[:4]])).cuda()
    base = DEFAULT_TRAINING_CONFIG.replace(cnn=True, compute_dtype="bfloat16")
    state = create_train_state(base, seed=0, device="cuda")
    for layout, impl in (("scan", "inline"), ("stepparallel", "xla")):
        config = base.replace(decoder_layout=layout, st_impl=impl)
        noise = draw_noise(config, 64, step_generator(0, 0, "cuda"), "cuda")
        step = make_train_step(config, with_grad_stats=True)
        runs = {}
        for on in (True, False):
            runs[on] = _run_with(step, state, images, digits, noise, on)
        grads = [tree_leaves(runs[on][1]["grad_tensors"]["original"])
                 for on in (True, False)]
        print(json.dumps({
            "train_step": layout, "st_impl": impl,
            "loss_on": float(runs[True][1]["loss"]),
            "loss_off": float(runs[False][1]["loss"]),
            "loss_bits_equal": bool(torch.equal(runs[True][1]["loss"],
                                                runs[False][1]["loss"])),
            "max_grad_diff": max(float((a - b).abs().max())
                                 for a, b in zip(*grads)),
            "grads_bit_equal": all(torch.equal(a, b)
                                   for a, b in zip(*grads))}), flush=True)


def _run_with(step, state, images, digits, noise, on: bool):
    """One train step with the reduction setting ``on``: the step sets the
    port's flags on its way in, so the setting follows them there."""
    import air_tpu_torch.models.air as air
    import air_tpu_torch.train.steps as steps
    flags = air._numeric_flags

    def flags_then_setting():
        flags()
        set_reduction(on)

    air._numeric_flags = steps._numeric_flags = flags_then_setting
    try:
        out = step(state, images, digits, noise=noise)
        torch.cuda.synchronize()
        return out
    finally:
        air._numeric_flags = steps._numeric_flags = flags


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _numeric_flags()
    products()
    train_steps()


if __name__ == "__main__":
    main()
