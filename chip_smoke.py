#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (air_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, one flushed line each, every line with the card's name and power
limit as nvidia-smi reports them:

  1. device   the card's name and count; fails without CUDA.
  2. build    nvcc builds the kernels into air_tpu_torch/_build/; prints the
              seconds and the -Xptxas -v register / shared-memory report.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              B = 64, 1 and 7 (max abs diff <= 1e-5).
  4. serve    ModelWrapper on the shipped CNN checkpoint with st_impl="inline"
              answers 1, 8 and 60 canvases of the committed fixture; every
              infer call launches each kernel max_steps times; digit-count
              accuracy >= 0.9; the same requests through the plain versions
              agree (reconstructions to 1e-4, digit counts exactly).
  5. times    device time per launch of each kernel, its plain version and a
              PyTorch matmul yardstick at B = 64 (CUDA graphs of back-to-back
              launches, timed with CUDA events), the bound from the published
              H100 SXM peaks, and the infer latency for 1 and 64 canvases.

Then a JSON line of the kernels, the nvidia-smi line and, last, the result
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
result line is printed. Nothing is written outside air_tpu_torch/_build/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from air_tpu_torch.kernels import build, st_inline
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
from air_tpu_torch.ops.transformer import _axis_weight_matrix
from air_tpu_torch.serve.model_wrapper import ModelWrapper
from air_tpu_torch.train.checkpoint import checkpoint_arch, load_params

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
SOURCE = "air_tpu_torch/kernels/csrc/st_inline.cu"
DEVICE = "cuda"

TIME_BUDGET_S = 180.0
KERNEL_TOL = 1e-5       # kernel vs plain version, fp32 FMA in both
PATH_TOL = 1e-4         # served reconstructions, kernels vs plain versions
MIN_ACCURACY = 0.9      # the bar of the JAX package's shipped-model test
BATCH = 64              # the serving bucket of the 60-canvas request
CS, WS = 50, 28
# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

T0 = time.perf_counter()


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def say(phase: str, card_line: str, msg: str) -> None:
    print(f"[{phase}] +{time.perf_counter() - T0:.1f}s ({card_line}) {msg}",
          flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def scalars(b: int, gen: torch.Generator):
    """s in [0.1, 1], x and y in [-1, 1]."""
    u = torch.rand((3, b), generator=gen, device=DEVICE)
    return 0.1 + 0.9 * u[0], 2.0 * u[1] - 1.0, 2.0 * u[2] - 1.0


def kernel_inputs(b: int, seed: int) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    s, x, y = scalars(b, gen)
    return dict(
        img=torch.rand((b, CS, CS), generator=gen, device=DEVICE),
        win=torch.rand((b, WS, WS), generator=gen, device=DEVICE),
        canvas=torch.rand((b, CS * CS), generator=gen, device=DEVICE),
        coeff=torch.rand((b,), generator=gen, device=DEVICE),
        s=s, x=x, y=y)


def run_read(d):
    return st_inline.inline_attention_read(d["img"], d["s"], d["x"], d["y"],
                                           WS)


def run_read_plain(d):
    return st_inline.attention_read_plain(d["img"], d["s"], d["x"], d["y"],
                                          WS)


def run_write(d):
    return st_inline.inline_write_accumulate(
        d["canvas"], d["win"], d["s"], d["x"], d["y"], d["coeff"], CS)


def run_write_plain(d):
    return st_inline.write_accumulate_plain(
        d["canvas"].reshape(-1, CS, CS), d["win"], d["s"], d["x"], d["y"],
        d["coeff"], CS).reshape(-1, CS * CS)


def device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``reps`` back-to-back calls captured in
    one CUDA graph, replayed ``replays`` times between two CUDA events, so
    the host's launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    card_line = card()

    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say("device", card_line, f"name={name} count={count} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")

    # 2. build
    lib = build.load("st_inline")
    report = " | ".join(line.strip() for line in lib.ptxas_report.splitlines()
                        if "registers" in line or "smem" in line
                        or "entry function" in line or "spill" in line)
    say("build", card_line, f"seconds={lib.build_seconds:.1f} "
        f"library={lib.path.name} ptxas: {report}")

    # 3. kernels against their plain versions
    err = {"inline_attention_read": 0.0, "inline_write_accumulate": 0.0}
    for b in (BATCH, 1, 7):
        d = kernel_inputs(b, seed=b)
        for kname, got_fn, want_fn in (
                ("inline_attention_read", run_read, run_read_plain),
                ("inline_write_accumulate", run_write, run_write_plain)):
            got = got_fn(d)
            torch.cuda.synchronize()
            want = want_fn(d)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err[kname] = max(err[kname], e)
            if not (e <= KERNEL_TOL):
                fail(f"{kname} at B={b}: max abs diff {e} > {KERNEL_TOL}")
    say("kernels", card_line, "kernel vs plain max abs diff "
        + " ".join(f"{k}={v:.3g}" for k, v in err.items())
        + f" (tol {KERNEL_TOL}, B=64,1,7)")

    # 4. the main path: serving the shipped CNN checkpoint
    arch = checkpoint_arch(CKPT)
    config = DEFAULT_TRAINING_CONFIG.replace(**arch, st_impl="inline")
    params = load_params(CKPT)
    with np.load(FIXTURE) as z:
        canvases, truth = z["canvases"], z["digits"]
    requests = [canvases[:1], canvases[:8], canvases]
    wrapper = ModelWrapper(config, params, seed=0, device=DEVICE)
    plain = ModelWrapper(config.replace(st_impl="xla"), params, seed=0,
                         decoder_layout="scan", device=DEVICE)

    st_inline.reset_launches()
    served = []
    for req in requests:
        before = dict(st_inline.LAUNCHES)
        served.append(wrapper.infer(req))
        for k, v in st_inline.LAUNCHES.items():
            if v - before[k] != config.max_steps:
                fail(f"{k} launched {v - before[k]} times in one infer "
                     f"call of {len(req)} canvases, expected "
                     f"{config.max_steps}")
    launches = dict(st_inline.LAUNCHES)
    for k, v in launches.items():
        if v == 0:
            fail(f"{k} was not launched on the main path")

    digits, _, recons, windows, _, losses = served[-1]
    for i, r in enumerate(recons):
        if r.shape != (CS, CS) or not np.all(np.isfinite(r)):
            fail(f"reconstruction {i}: shape {r.shape} or non-finite values")
    if not np.all(np.isfinite(losses)):
        fail("non-finite reconstruction loss")
    accuracy = float(np.mean(np.asarray(digits) == truth))
    if accuracy < MIN_ACCURACY:
        fail(f"digit-count accuracy {accuracy} < {MIN_ACCURACY}")

    path_err = 0.0
    for req, got in zip(requests, served):
        want = plain.infer(req)
        if list(got[0]) != list(want[0]):
            fail(f"digit counts differ from the plain path on {len(req)} "
                 f"canvases")
        path_err = max(path_err, max(float(np.max(np.abs(a - b)))
                                     for a, b in zip(got[2], want[2])))
    if not (path_err <= PATH_TOL):
        fail(f"reconstructions differ from the plain path by {path_err}")
    say("serve", card_line, f"requests={[len(r) for r in requests]} "
        f"launches={launches} accuracy={accuracy:.4f} "
        f"recon_vs_plain_max_abs={path_err:.3g} (tol {PATH_TOL})")

    # 5. times at B = 64
    d = kernel_inputs(BATCH, seed=1234)
    wy_r = _axis_weight_matrix(d["s"], d["y"], WS, CS)
    wx_r = _axis_weight_matrix(d["s"], d["x"], WS, CS).transpose(1, 2)
    inv_s = 1.0 / d["s"]
    wy_w = (_axis_weight_matrix(inv_s, -d["y"] * inv_s, CS, WS)
            * d["coeff"][:, None, None])
    wx_w = _axis_weight_matrix(inv_s, -d["x"] * inv_s, CS, WS).transpose(1, 2)
    canvas3 = d["canvas"].reshape(-1, CS, CS)
    f32 = 4
    read_bytes = f32 * BATCH * (CS * CS + 4 + WS * WS)
    read_flops = 2 * BATCH * (WS * CS * CS + WS * WS * CS)
    write_bytes = f32 * BATCH * (CS * CS + WS * WS + 5 + CS * CS)
    write_flops = 2 * BATCH * (CS * WS * WS + CS * CS * WS + CS * CS)
    rows = []
    for kname, line, fn, plain_fn, lib_fn, nbytes, flops in (
            ("inline_attention_read", 222, run_read, run_read_plain,
             lambda: torch.matmul(torch.matmul(wy_r, d["img"]), wx_r),
             read_bytes, read_flops),
            ("inline_write_accumulate", 70, run_write, run_write_plain,
             lambda: torch.baddbmm(canvas3, torch.bmm(wy_w, d["win"]), wx_w),
             write_bytes, write_flops)):
        ms = device_ms(lambda: fn(d))
        plain_ms = device_ms(lambda: plain_fn(d))
        library_ms = device_ms(lib_fn)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": f"air_tpu/kernels/st_inline.py:{line}",
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms})
        say("times", card_line, f"{kname} B={BATCH}: ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}; {nbytes} B, {flops} FLOP)")

    lat = {}
    for n in (1, 64):
        req = canvases[np.arange(n) % len(canvases)]
        wrapper.infer(req)
        runs = []
        for _ in range(10):
            t = time.perf_counter()
            wrapper.infer(req)
            runs.append((time.perf_counter() - t) * 1e3)
        lat[n] = float(np.median(runs))
    say("times", card_line, f"infer latency median of 10: "
        f"1 canvas {lat[1]:.3f} ms, 64 canvases {lat[64]:.3f} ms")

    elapsed = time.perf_counter() - T0
    if elapsed > TIME_BUDGET_S:
        print(f"note: {elapsed:.0f}s is over the {TIME_BUDGET_S:.0f}s budget",
              file=sys.stderr, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
