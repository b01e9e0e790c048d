#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (air_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Two paths of the attention read and write-accumulate are driven, each
through its hand-written CUDA kernels: st_impl="inline" (kernels that build
the bilinear weights inside: st_inline.cu) and st_impl="pallas" (the dense
weight matrices streamed in: st_pallas.cu for the read, st_fused.cu for the
write-accumulate and its backward). Phases, one flushed line each, every
line with the card's name and power limit as nvidia-smi reports them:

  1. device   the card's name and count; fails without CUDA.
  2. build    nvcc builds the kernels into air_tpu_torch/_build/, one nvcc
              per source, all started together; prints the seconds and the
              -Xptxas -v register / shared-memory report.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              B = 64, 1 and 7 (the streamed-weight resample in both its
              directions): values and matrix cotangents to max abs diff
              1e-5, scalar cotangents to 1e-4 * max(1, |plain|).
  4. serve    ModelWrapper on the shipped CNN checkpoint, for each path,
              answers 1, 8 and 60 canvases of the committed fixture; every
              infer call launches each of the path's forward kernels
              max_steps times and no other kernel; digit-count accuracy >=
              0.9; the same requests through the plain versions agree
              (reconstructions to 1e-4, digit counts exactly).
  5. train    the training step of DEFAULT_TRAINING_CONFIG with cnn=True at
              full width, batch 64 (the 60 fixture canvases and their first
              4 again), from create_train_state (seed 0), for each path.
              Step 0 through the kernels against step 0 through the plain
              path (st_impl="xla") at the same params and draws: loss and
              grad_norm to 1e-4 relative, every gradient leaf to 1e-4 *
              max(1, max |leaf|). Then TRAIN_STEPS steps through the kernels
              (the path's main run): each step launches each of the path's
              kernels max_steps times and no other kernel, every loss is
              finite, every parameter leaf moves, and the mean
              reconstruction loss of the last 5 steps is below that of the
              first 5. The eval summaries of the trained state are finite
              wherever their slice is non-empty, and save_checkpoint /
              load_checkpoint (in a temporary directory) round-trip params,
              moments and step bit for bit. Last, two runs of the first
              DETERMINISM_STEPS steps from the same state give the same
              losses bit for bit.
  6. times    device time per launch of each kernel, its plain version and a
              PyTorch yardstick at B = 64 (CUDA graphs of back-to-back
              launches, timed with CUDA events), the bound from the published
              H100 SXM peaks; the streamed-weight kernels (the resample in
              both directions, the write-accumulate forward) again at B = 64,
              256 and 1024 beside their yardsticks; the infer latency for 1
              and 64 canvases; the
              train step (median of 10, host clock, each ending in a
              synchronize) through each path's kernels and through the plain
              path.

Then a JSON line of the kernels, the nvidia-smi line and, last, the result
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
result line is printed. Nothing is written outside air_tpu_torch/_build/ and
a temporary directory that is removed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from air_tpu_torch.kernels import build, st_fused, st_inline, st_pallas
from air_tpu_torch.models.air import draw_noise
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
from air_tpu_torch.ops.transformer import _axis_weight_matrix
from air_tpu_torch.serve.model_wrapper import ModelWrapper
from air_tpu_torch.train.checkpoint import (checkpoint_arch, load_checkpoint,
                                            load_params, save_checkpoint)
from air_tpu_torch.train.metrics import summarize_outputs
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       step_generator)
from air_tpu_torch.tree import tree_leaves, tree_leaves_with_path

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
MODULES = (st_inline, st_pallas, st_fused)
LIBRARIES = ("st_inline", "st_pallas", "st_fused")
DEVICE = "cuda"

TIME_BUDGET_S = 180.0
KERNEL_TOL = 1e-5       # kernel vs plain version, fp32 FMA in both
SCALAR_TOL = 1e-4       # backward scalar cotangents, x max(1, |plain|)
PATH_TOL = 1e-4         # served reconstructions, kernels vs plain versions
GRAD_TOL = 1e-4         # train step 0, kernels vs plain path
MIN_ACCURACY = 0.9      # the bar of the JAX package's shipped-model test
BATCH = 64              # the serving bucket of the 60-canvas request
SWEEP_BATCHES = (BATCH, 256, 1024)   # phase 6's streamed-weight kernels
CS, WS = 50, 28
# steps of the main path's training run: the JAX package at this config on
# the same 64 canvases lowers the mean reconstruction loss of the last 5
# steps by 16-24% below that of the first 5 in 60 steps (seeds 0 and 1),
# less reliably in 30-40 (PERF.md)
TRAIN_STEPS = 60
DETERMINISM_STEPS = 10
# the kernels each path launches: (forward, backward)
PATHS = {
    "inline": (("inline_attention_read", "inline_write_accumulate"),
               ("inline_attention_read_bwd", "inline_write_accumulate_bwd")),
    "pallas": (("pallas_attention_read", "fused_write_accumulate"),
               ("fused_write_accumulate_bwd",)),
}
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


def reset_launches() -> None:
    for module in MODULES:
        module.reset_launches()


def launches() -> dict:
    """Every kernel's launch count, over the three kernel modules."""
    return {k: v for module in MODULES for k, v in module.LAUNCHES.items()}


def expect_launches(before: dict, want: dict, what: str) -> None:
    """Fail unless the counts moved by ``want`` since ``before`` and every
    other kernel stayed where it was."""
    now = launches()
    moved = {k: now[k] - before[k] for k in now}
    expected = {k: want.get(k, 0) for k in now}
    if moved != expected:
        fail(f"{what} launched {moved}, expected {expected}")


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


def core_inputs(d: dict, seed: int) -> dict:
    """The per-axis scalars (a, c) as the inline wrappers form them from
    (s, x, y), the dense weight matrices [B, out, in] the streamed-weight
    wrappers build from them, and random output cotangents of the read
    [B, ws, ws] and of the write [B, cs, cs]."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    b = d["s"].shape[0]
    inv_s = 1.0 / d["s"]
    read = (d["s"], d["y"], d["s"], d["x"])
    write = (inv_s, -d["y"] * inv_s, inv_s, -d["x"] * inv_s)
    return dict(
        read=read, write=write,
        w_read=(_axis_weight_matrix(read[0], read[1], WS, CS),
                _axis_weight_matrix(read[2], read[3], WS, CS)),
        w_write=(_axis_weight_matrix(write[0], write[1], CS, WS),
                 _axis_weight_matrix(write[2], write[3], CS, WS)),
        g_read=torch.randn((b, WS, WS), generator=gen, device=DEVICE),
        g_write=torch.randn((b, CS, CS), generator=gen, device=DEVICE))


def canvas3(d):
    return d["canvas"].reshape(-1, CS, CS)


# each kernel: (its wrapper, its plain version, the number of matrix
# outputs before the scalar ones), all on the inputs of kernel_inputs and
# core_inputs
KERNELS = {
    "inline_attention_read": (
        lambda d, e: st_inline.attention_read_fwd(d["img"], *e["read"], WS),
        lambda d, e: st_inline.attention_read_fwd_plain(d["img"], *e["read"],
                                                        WS), 1),
    "inline_write_accumulate": (
        lambda d, e: st_inline.write_accumulate_fwd(
            canvas3(d), d["win"], *e["write"], d["coeff"]),
        lambda d, e: st_inline.write_accumulate_fwd_plain(
            canvas3(d), d["win"], *e["write"], d["coeff"]), 1),
    "inline_attention_read_bwd": (
        lambda d, e: st_inline.attention_read_bwd(d["img"], e["g_read"],
                                                  *e["read"]),
        lambda d, e: st_inline.attention_read_bwd_plain(
            d["img"], e["g_read"], *e["read"]), 1),
    "inline_write_accumulate_bwd": (
        lambda d, e: st_inline.write_accumulate_bwd(
            d["win"], e["g_write"], *e["write"], d["coeff"]),
        lambda d, e: st_inline.write_accumulate_bwd_plain(
            d["win"], e["g_write"], *e["write"], d["coeff"]), 1),
    "pallas_attention_read": (
        lambda d, e: st_pallas.fused_dots(e["w_read"][0], d["img"],
                                          e["w_read"][1],
                                          "pallas_attention_read"),
        lambda d, e: st_pallas.fused_dots_plain(e["w_read"][0], d["img"],
                                                e["w_read"][1]), 1),
    "pallas_attention_write": (
        lambda d, e: st_pallas.fused_dots(e["w_write"][0], d["win"],
                                          e["w_write"][1],
                                          "pallas_attention_write"),
        lambda d, e: st_pallas.fused_dots_plain(e["w_write"][0], d["win"],
                                                e["w_write"][1]), 1),
    "fused_write_accumulate": (
        lambda d, e: st_fused.wmac_fwd(canvas3(d), d["win"], *e["w_write"],
                                       d["coeff"]),
        lambda d, e: st_fused.wmac_fwd_plain(canvas3(d), d["win"],
                                             *e["w_write"], d["coeff"]), 1),
    "fused_write_accumulate_bwd": (
        lambda d, e: st_fused.wmac_bwd(d["win"], *e["w_write"], d["coeff"],
                                       e["g_write"]),
        lambda d, e: st_fused.wmac_bwd_plain(d["win"], *e["w_write"],
                                             d["coeff"], e["g_write"]), 3),
}


def errors(got, want, n_mat: int) -> tuple[float, float]:
    """(max abs diff over the matrix outputs, max over the scalar outputs of
    |diff| / max(1, |plain|))."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    mat = max(float((g - w).abs().max())
              for g, w in zip(got[:n_mat], want[:n_mat]))
    scal = max((float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                for g, w in zip(got[n_mat:], want[n_mat:])), default=0.0)
    return mat, scal


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


def check_serve(impl: str, params, canvases, truth, card_line: str):
    """Phase 4 for one path. Returns its wrapper."""
    arch = checkpoint_arch(CKPT)
    config = DEFAULT_TRAINING_CONFIG.replace(**arch, st_impl=impl)
    fwd = PATHS[impl][0]
    requests = [canvases[:1], canvases[:8], canvases]
    wrapper = ModelWrapper(config, params, seed=0, device=DEVICE)
    # the same seed and calls: the same draws
    plain = ModelWrapper(config.replace(st_impl="xla"), params, seed=0,
                         decoder_layout="scan", device=DEVICE)

    reset_launches()
    served = []
    for req in requests:
        before = launches()
        served.append(wrapper.infer(req))
        expect_launches(before, {k: config.max_steps for k in fwd},
                        f"one infer call of {len(req)} canvases ({impl})")
    serve_launches = {k: launches()[k] for k in fwd}

    digits, _, recons, windows, _, losses = served[-1]
    for i, r in enumerate(recons):
        if r.shape != (CS, CS) or not np.all(np.isfinite(r)):
            fail(f"{impl} reconstruction {i}: shape {r.shape} or non-finite "
                 "values")
    if not np.all(np.isfinite(losses)):
        fail(f"{impl}: non-finite reconstruction loss")
    accuracy = float(np.mean(np.asarray(digits) == truth))
    if accuracy < MIN_ACCURACY:
        fail(f"{impl}: digit-count accuracy {accuracy} < {MIN_ACCURACY}")

    path_err = 0.0
    for req, got in zip(requests, served):
        want = plain.infer(req)
        if list(got[0]) != list(want[0]):
            fail(f"{impl}: digit counts differ from the plain path on "
                 f"{len(req)} canvases")
        path_err = max(path_err, max(float(np.max(np.abs(a - b)))
                                     for a, b in zip(got[2], want[2])))
    if not (path_err <= PATH_TOL):
        fail(f"{impl}: reconstructions differ from the plain path by "
             f"{path_err}")
    say("serve", card_line, f"st_impl={impl} "
        f"requests={[len(r) for r in requests]} launches={serve_launches} "
        f"accuracy={accuracy:.4f} recon_vs_plain_max_abs={path_err:.3g} "
        f"(tol {PATH_TOL})")
    return wrapper


def check_train(config, state0, images, digits, card_line: str) -> dict:
    """Phase 5 for the path of ``config.st_impl``. Returns the launches of
    each of the path's kernels over its TRAIN_STEPS steps."""
    impl, steps = config.st_impl, config.max_steps
    per_step = {k: steps for k in PATHS[impl][0] + PATHS[impl][1]}
    noise = draw_noise(config, BATCH, step_generator(0, 0, DEVICE), DEVICE)
    graded = {name: make_train_step(config.replace(st_impl=name),
                                    with_grad_stats=True)
              for name in (impl, "xla")}
    before = launches()
    _, m_k = graded[impl](state0, images, digits, noise=noise)
    torch.cuda.synchronize()
    expect_launches(before, per_step, f"step 0 through the {impl} kernels")
    before = launches()
    _, m_p = graded["xla"](state0, images, digits, noise=noise)
    torch.cuda.synchronize()
    expect_launches(before, {}, "the plain path")
    rel = {k: abs(float(m_k[k]) - float(m_p[k])) / abs(float(m_p[k]))
           for k in ("loss", "grad_norm")}
    grad_err = 0.0
    for (path, g), w in zip(
            tree_leaves_with_path(m_k["grad_tensors"]["original"]),
            tree_leaves(m_p["grad_tensors"]["original"])):
        e = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        grad_err = max(grad_err, e)
        if not (e <= GRAD_TOL):
            fail(f"{impl} step 0 gradient of {'/'.join(map(str, path))}: "
                 f"kernels vs plain path {e} > {GRAD_TOL} x max(1, max "
                 "|leaf|)")
    if not all(v <= GRAD_TOL for v in rel.values()):
        fail(f"{impl} step 0 kernels vs plain path, relative diff {rel} > "
             f"{GRAD_TOL}")
    say("train", card_line, f"st_impl={impl} step 0 kernels vs plain path: "
        f"loss {float(m_k['loss']):.4f} vs {float(m_p['loss']):.4f} (rel "
        f"{rel['loss']:.3g}), grad_norm rel {rel['grad_norm']:.3g}, "
        f"gradient leaves max |diff| / max(1, max |leaf|) {grad_err:.3g} "
        f"(tol {GRAD_TOL})")

    # the path's main run: TRAIN_STEPS steps through the kernels
    train_step = make_train_step(config)
    state = state0
    losses, recons = [], []
    reset_launches()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = launches()
        state, m = train_step(state, images, digits)
        expect_launches(before, per_step, f"{impl} train step {i}")
        losses.append(float(m["loss"]))
        recons.append(float(m["reconstruction_loss"]))
    seconds = time.perf_counter() - t0
    main_launches = {k: launches()[k] for k in per_step}
    if not np.all(np.isfinite(losses)):
        fail(f"{impl}: non-finite training loss: {losses}")
    still = [path for (path, a), b in zip(tree_leaves_with_path(state.params),
                                          tree_leaves(state0.params))
             if torch.equal(a, b)]
    if still:
        fail(f"{impl}: parameter leaves that did not move: {still}")
    first5, last5 = float(np.mean(recons[:5])), float(np.mean(recons[-5:]))
    if not last5 < first5:
        fail(f"{impl}: mean reconstruction loss of the last 5 steps {last5} "
             f"is not below that of the first 5 {first5}")
    say("train", card_line, f"st_impl={impl} {TRAIN_STEPS} steps in "
        f"{seconds:.2f} s, launches={main_launches}, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}, reconstruction loss mean of "
        f"first 5 {first5:.3f}, last 5 {last5:.3f}; every parameter leaf "
        "moved")

    out = make_eval_step(config)(state.params, images, digits, state.step,
                                 generator=step_generator(0, state.step,
                                                          DEVICE))
    summary = summarize_outputs(out, digits, steps, config.max_digits)
    # a slice is NaN exactly where its mask is empty: the same summaries of
    # all-ones outputs (digit counts kept, they define the masks) tell where
    ones = out._replace(**{f: torch.ones_like(getattr(out, f))
                           for f in out._fields if f != "rec_num_digits"})
    defined = summarize_outputs(ones, digits, steps, config.max_digits)
    bad = [k for k, v in summary.items()
           if bool(torch.isfinite(v)) != bool(torch.isfinite(defined[k]))]
    if bad or set(summary) != set(defined):
        fail(f"{impl}: eval summaries not finite where their slice is "
             f"non-empty: {bad}")
    n_nan = sum(1 for v in defined.values() if not torch.isfinite(v))
    say("train", card_line, f"st_impl={impl} eval summary of the trained "
        f"state: {len(summary)} values, all finite except {n_nan} empty "
        f"slices (NaN by definition); accuracy "
        f"{float(summary['accuracy']):.4f}, loss "
        f"{float(summary['loss']):.3f}")

    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, state)
        loaded = load_checkpoint(path, config, device=DEVICE)
    same = (loaded.step == state.step and loaded.seed == state.seed
            and loaded.opt_state.count == state.opt_state.count)
    for a_tree, b_tree in ((loaded.params, state.params),
                           (loaded.opt_state.mu, state.opt_state.mu),
                           (loaded.opt_state.nu, state.opt_state.nu)):
        same = same and all(a.dtype == b.dtype and torch.equal(a, b)
                            for a, b in zip(tree_leaves(a_tree),
                                            tree_leaves(b_tree)))
    if not same:
        fail(f"{impl}: checkpoint round trip changed the state")
    say("train", card_line, f"st_impl={impl} checkpoint at step "
        f"{state.step} saved and loaded back bit for bit (params, bf16 "
        "moments, counts)")

    runs = []
    for _ in range(2):
        state, bits = state0, []
        for _ in range(DETERMINISM_STEPS):
            state, m = train_step(state, images, digits)
            bits.append(m["loss"].view(torch.int32).item())
        runs.append(bits)
    if runs[0] != runs[1]:
        first = next(i for i, (a, b) in enumerate(zip(*runs)) if a != b)
        fail(f"{impl}: two runs of {DETERMINISM_STEPS} steps from the same "
             f"state part at step {first}")
    say("train", card_line, f"st_impl={impl} two runs of "
        f"{DETERMINISM_STEPS} steps from the same state: losses bit-equal")
    return main_launches


def train_step_ms(train_step, state, images, digits, runs: int = 10):
    """Median host time of one train step that ends in a synchronize."""
    for _ in range(2):
        state, _ = train_step(state, images, digits)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        state, _ = train_step(state, images, digits)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    card_line = card()

    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say("device", card_line, f"name={name} count={count} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")

    # 2. build: one nvcc per source, all started together
    t_build = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(build.load, LIBRARIES)))
    for lib_name, lib in libs.items():
        report = " | ".join(
            line.strip() for line in lib.ptxas_report.splitlines()
            if "registers" in line or "smem" in line
            or "entry function" in line or "spill" in line)
        say("build", card_line, f"{lib_name}: seconds="
            f"{lib.build_seconds:.1f} library={lib.path.name} ptxas: "
            f"{report}")
    say("build", card_line, f"all {len(libs)} libraries in "
        f"{time.perf_counter() - t_build:.1f} s")

    # 3. kernels against their plain versions
    err = {k: 0.0 for k in KERNELS}
    scalar_err = {k: 0.0 for k in KERNELS}
    for b in (BATCH, 1, 7):
        d = kernel_inputs(b, seed=b)
        e_in = core_inputs(d, seed=100 + b)
        for kname, (got_fn, want_fn, n_mat) in KERNELS.items():
            got = got_fn(d, e_in)
            torch.cuda.synchronize()
            want = want_fn(d, e_in)
            torch.cuda.synchronize()
            mat, scal = errors(got, want, n_mat)
            err[kname] = max(err[kname], mat)
            scalar_err[kname] = max(scalar_err[kname], scal)
            if not (mat <= KERNEL_TOL and scal <= SCALAR_TOL):
                fail(f"{kname} at B={b}: matrix max abs diff {mat} (tol "
                     f"{KERNEL_TOL}), scalar rel diff {scal} (tol "
                     f"{SCALAR_TOL})")
    say("kernels", card_line, "kernel vs plain max abs diff "
        + " ".join(f"{k}={v:.3g}" for k, v in err.items())
        + f" (tol {KERNEL_TOL}); backward scalar cotangents |diff| / "
        "max(1, |plain|) "
        + " ".join(f"{k}={v:.3g}" for k, v in scalar_err.items()
                   if k.endswith("_bwd"))
        + f" (tol {SCALAR_TOL}); B=64,1,7")

    # 4. serving the shipped CNN checkpoint, through each path's kernels
    params = load_params(CKPT)
    with np.load(FIXTURE) as z:
        canvases, truth = z["canvases"], z["digits"]
    wrappers = {impl: check_serve(impl, params, canvases, truth, card_line)
                for impl in PATHS}

    # 5. train, through each path's kernels
    train_cfg = DEFAULT_TRAINING_CONFIG.replace(cnn=True)
    images = torch.from_numpy(np.concatenate([canvases, canvases[:4]])).to(
        DEVICE)
    digits = torch.from_numpy(np.concatenate([truth, truth[:4]])).to(DEVICE)
    state0 = create_train_state(train_cfg, seed=0, device=DEVICE)
    train_launches = {}
    for impl in PATHS:
        train_launches.update(check_train(train_cfg.replace(st_impl=impl),
                                          state0, images, digits, card_line))

    # 6. times at B = 64
    d = kernel_inputs(BATCH, seed=1234)
    e_in = core_inputs(d, seed=4321)
    wy_r, wx_r = e_in["w_read"]
    wy_w, wx_w = e_in["w_write"]
    f32 = 4
    read_bytes = f32 * BATCH * (CS * CS + 4 + WS * WS)
    read_flops = 2 * BATCH * (WS * CS * CS + WS * WS * CS)
    write_bytes = f32 * BATCH * (CS * CS + WS * WS + 5 + CS * CS)
    write_flops = 2 * BATCH * (CS * WS * WS + CS * CS * WS + CS * CS)
    # backward: the products with a weight matrix dense, as counted for the
    # forward kernels (read: g Wx, Wy^T (g Wx), Wy img; write: g Wx,
    # Wy^T (g Wx), Wy win), but dWy and dWx only at the at most two taps
    # per row that the scalar cotangents take, and d_coeff as <Wy win, g Wx>
    read_bwd_bytes = f32 * BATCH * (2 * CS * CS + WS * WS + 8)
    read_bwd_flops = 2 * BATCH * (WS * WS * CS + 2 * WS * CS * CS
                                  + 2 * WS * CS + 2 * WS * WS)
    write_bwd_bytes = f32 * BATCH * (2 * WS * WS + CS * CS + 10)
    write_bwd_flops = 2 * BATCH * (CS * CS * WS + 2 * CS * WS * WS
                                   + CS * WS + 2 * CS * WS + 2 * CS * CS)
    # streamed weights: both [B, out, in] weight matrices read as inputs;
    # the backward's dWy and dWx are outputs, dense, as is their work (gwx,
    # tmp, dWy, d_win, dWx, and d_coeff as <gwx, tmp>)
    dots_bytes = f32 * BATCH * (CS * CS + 2 * WS * CS + WS * WS)
    dots_flops = read_flops
    wmac_bytes = f32 * BATCH * (2 * CS * WS + WS * WS + 1 + 2 * CS * CS)
    wmac_flops = write_flops
    wmac_bwd_bytes = f32 * BATCH * (2 * CS * WS + WS * WS + 1 + CS * CS
                                    + 2 * CS * WS + WS * WS + 1)
    wmac_bwd_flops = 2 * BATCH * (2 * CS * CS * WS + 3 * CS * WS * WS
                                  + CS * WS)
    # library yardstick: a batched matmul chain with the weights prebuilt;
    # of a backward, torch.autograd.grad through it with respect to the
    # input and both weights (no scalar contraction, and for the streamed
    # write no d_coeff), timed as forward + grad less the forward
    leaves_r = [t.detach().clone().requires_grad_(True)
                for t in (d["img"], wy_r, wx_r.transpose(1, 2))]
    leaves_w = [t.detach().clone().requires_grad_(True)
                for t in (d["win"], wy_w * d["coeff"][:, None, None],
                          wx_w.transpose(1, 2))]

    def lib_read_fwd():
        return torch.matmul(torch.matmul(leaves_r[1], leaves_r[0]),
                            leaves_r[2])

    def lib_write_fwd():
        return torch.baddbmm(canvas3(d), torch.bmm(leaves_w[1], leaves_w[0]),
                             leaves_w[2])

    def lib_read_bwd():
        return torch.autograd.grad(lib_read_fwd(), leaves_r, e_in["g_read"])

    def lib_write_bwd():
        return torch.autograd.grad(lib_write_fwd(), leaves_w,
                                   e_in["g_write"])

    rows = []
    for kname, source, replaces, lib_fn, lib_less, nbytes, flops in (
            ("inline_attention_read", "st_inline.cu", "st_inline.py:222",
             lib_read_fwd, None, read_bytes, read_flops),
            ("inline_write_accumulate", "st_inline.cu", "st_inline.py:70",
             lib_write_fwd, None, write_bytes, write_flops),
            ("inline_attention_read_bwd", "st_inline.cu", "st_inline.py:234",
             lib_read_bwd, lib_read_fwd, read_bwd_bytes, read_bwd_flops),
            ("inline_write_accumulate_bwd", "st_inline.cu",
             "st_inline.py:83", lib_write_bwd, lib_write_fwd,
             write_bwd_bytes, write_bwd_flops),
            ("fused_write_accumulate", "st_fused.cu", "st_fused.py:52",
             lib_write_fwd, None, wmac_bytes, wmac_flops),
            ("fused_write_accumulate_bwd", "st_fused.cu", "st_fused.py:63",
             lib_write_bwd, lib_write_fwd, wmac_bwd_bytes, wmac_bwd_flops),
            ("pallas_attention_read", "st_pallas.cu", "st_pallas.py:41",
             lib_read_fwd, None, dots_bytes, dots_flops)):
        fn, plain_fn, _ = KERNELS[kname]
        ms = device_ms(lambda: fn(d, e_in))
        plain_ms = device_ms(lambda: plain_fn(d, e_in))
        library_ms = device_ms(lib_fn)
        if lib_less is not None:
            library_ms -= device_ms(lib_less)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"air_tpu_torch/kernels/csrc/{source}",
            "replaces": f"air_tpu/kernels/{replaces}",
            "launches": train_launches[kname], "max_abs_err": err[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms})
        say("times", card_line, f"{kname} B={BATCH}: ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}; {nbytes} B, {flops} FLOP)")
    # the streamed-weight kernels (resample in both directions, the
    # write-accumulate forward) at B = 64, 256 and 1024, each beside its
    # library chain with the weights prebuilt and its bound
    for b in SWEEP_BATCHES:
        db = kernel_inputs(b, seed=2000 + b)
        eb = core_inputs(db, seed=3000 + b)
        (wy_r, wx_r), (wy_w, wx_w) = eb["w_read"], eb["w_write"]
        co_wy_w = wy_w * db["coeff"][:, None, None]
        wx_r_t, wx_w_t = wx_r.transpose(1, 2), wx_w.transpose(1, 2)
        sweep = (
            ("pallas_attention_read",
             lambda: torch.bmm(torch.bmm(wy_r, db["img"]), wx_r_t),
             f32 * b * (CS * CS + 2 * WS * CS + WS * WS),
             2 * b * (WS * CS * CS + WS * WS * CS)),
            ("pallas_attention_write",
             lambda: torch.bmm(torch.bmm(wy_w, db["win"]), wx_w_t),
             f32 * b * (WS * WS + 2 * CS * WS + CS * CS),
             2 * b * (CS * WS * WS + CS * CS * WS)),
            ("fused_write_accumulate",
             lambda: torch.baddbmm(canvas3(db), torch.bmm(co_wy_w, db["win"]),
                                   wx_w_t),
             f32 * b * (2 * CS * WS + WS * WS + 1 + 2 * CS * CS),
             2 * b * (CS * WS * WS + CS * CS * WS + CS * CS)))
        for kname, lib_fn, nbytes, flops in sweep:
            fn, plain_fn, _ = KERNELS[kname]
            ms = device_ms(lambda: fn(db, eb))
            library_ms = device_ms(lib_fn)
            plain_ms = device_ms(lambda: plain_fn(db, eb))
            b_ms, b_by = bound_ms(nbytes, flops)
            say("times", card_line, f"{kname} B={b}: ms={ms:.5f} "
                f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                f"ms/library={ms / library_ms:.3f} bound_ms={b_ms:.6f} "
                f"({b_by}; {nbytes} B, {flops} FLOP)")

    for impl, wrapper in wrappers.items():
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
        say("times", card_line, f"st_impl={impl} infer latency median of "
            f"10: 1 canvas {lat[1]:.3f} ms, 64 canvases {lat[64]:.3f} ms")
    for impl in (*PATHS, "xla"):
        ms = train_step_ms(make_train_step(train_cfg.replace(st_impl=impl)),
                           state0, images, digits)
        say("times", card_line, f"train step st_impl={impl} batch {BATCH} "
            f"median of 10: {ms:.3f} ms/step, {BATCH / ms * 1e3:.1f} "
            "images/s")

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
