#!/usr/bin/env python3
"""Whether the port's train step gives the same bits twice in one process
on a CUDA card, and if not, where the runs part.

    python3 scripts/determinism_torch_train.py      # from the repository root

For each st_impl ("inline", "pallas") it builds the full-width training
state of DEFAULT_TRAINING_CONFIG with cnn=True (create_train_state, seed 0)
and takes batches of 64 from the committed fixture (the 60 canvases and
their first 4 again), then runs STEPS train steps from that state twice and
compares the two runs bit for bit: the losses, and every gradient leaf of
every step. It names the first step and the gradient leaves that differ,
and whether step 0's loss (the forward) and step 0's gradients repeat. It
prints the median step time of each run.

It does so in three settings, each in a process of its own:
  port      the port as it is (its numeric flags ask cuDNN for
            deterministic algorithms);
  atomics   torch.backends.cudnn.deterministic set back to False after the
            port's flags, cuDNN's default: the port before it asked;
  all       torch.use_deterministic_algorithms(True) on top of the port,
            with CUBLAS_WORKSPACE_CONFIG=:4096:8 set before the first cuBLAS
            call.
One JSON line per setting and st_impl. The port setting then times the
train step of each st_impl with and without cuDNN's deterministic
algorithms in one process, in turns (without, with, with, without; median
of TIMED_STEPS steps each, host clock, each step ending in a synchronize).
Prints the card's name and power limit first. Needs a card; writes nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import air_tpu_torch.models.air as air_model  # noqa: E402
import air_tpu_torch.train.steps as steps_module  # noqa: E402
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu_torch.train.state import create_train_state  # noqa: E402
from air_tpu_torch.train.steps import make_train_step  # noqa: E402
from air_tpu_torch.tree import tree_leaves_with_path  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
STEPS = 10
TIMED_STEPS = 20
SETTINGS = ("port", "atomics", "all")
PORT_FLAGS = air_model._numeric_flags
CUDNN_DETERMINISTIC = {"value": None}   # None: as the port's flags set it


def numeric_flags() -> None:
    """The port's numeric flags, then cuDNN's determinism as the setting
    asks."""
    PORT_FLAGS()
    if CUDNN_DETERMINISTIC["value"] is not None:
        torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC["value"]



def run(train_step, state, images, digits):
    """STEPS steps: per step the loss's bits and the gradient leaves (on
    the card), and the step times."""
    losses, grads, ms = [], [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        state, m = train_step(state, images, digits)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].view(torch.int32).item())
        grads.append([(("/".join(map(str, p))), g.detach().clone())
                      for p, g in tree_leaves_with_path(
                          m["grad_tensors"]["original"])])
    return losses, grads, ms


def compare(impl: str, setting: str, images, digits) -> dict:
    config = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl=impl)
    state0 = create_train_state(config, seed=0, device="cuda")
    train_step = make_train_step(config, with_grad_stats=True)
    train_step(state0, images, digits)            # warm up, build kernels
    a_loss, a_grads, a_ms = run(train_step, state0, images, digits)
    b_loss, b_grads, b_ms = run(train_step, state0, images, digits)
    first_loss = next((i for i in range(STEPS) if a_loss[i] != b_loss[i]),
                      None)
    first_grad, leaves = None, []
    for i in range(STEPS):
        leaves = [(name, float((ga - gb).abs().max()))
                  for (name, ga), (_, gb) in zip(a_grads[i], b_grads[i])
                  if not torch.equal(ga, gb)]
        if leaves:
            first_grad = i
            break
    return {"st_impl": impl, "setting": setting, "steps": STEPS,
            "losses_equal": first_loss is None,
            "first_loss_step_differing": first_loss,
            "first_grad_step_differing": first_grad,
            "leaves_differing_there": leaves,
            "step0_loss_equal": a_loss[0] == b_loss[0],
            "step0_grads_equal": all(torch.equal(ga, gb) for (_, ga), (_, gb)
                                     in zip(a_grads[0], b_grads[0])),
            "median_ms": [float(np.median(a_ms)), float(np.median(b_ms))]}


def step_ms(impl: str, images, digits) -> float:
    """Median host time of TIMED_STEPS train steps, each ending in a
    synchronize."""
    config = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl=impl)
    state = create_train_state(config, seed=0, device="cuda")
    train_step = make_train_step(config)
    for _ in range(2):
        state, _ = train_step(state, images, digits)
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        state, _ = train_step(state, images, digits)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def child(setting: str) -> None:
    air_model._numeric_flags = steps_module._numeric_flags = numeric_flags
    if setting == "atomics":
        CUDNN_DETERMINISTIC["value"] = False
    elif setting == "all":
        torch.use_deterministic_algorithms(True)
    with np.load(FIXTURE) as z:
        canvases, digits = z["canvases"], z["digits"]
    images = torch.from_numpy(np.concatenate([canvases, canvases[:4]])).cuda()
    targets = torch.from_numpy(np.concatenate([digits, digits[:4]])).cuda()
    for impl in ("inline", "pallas"):
        print(json.dumps(compare(impl, setting, images, targets)), flush=True)
    if setting != "port":
        return
    for impl in ("inline", "pallas"):
        turns = []
        for deterministic in (False, True, True, False):
            CUDNN_DETERMINISTIC["value"] = deterministic
            turns.append((deterministic, step_ms(impl, images, targets)))
        CUDNN_DETERMINISTIC["value"] = None
        print(json.dumps({"st_impl": impl, "timing": "ms per step in turns",
                          "cudnn_deterministic_and_ms": turns}), flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--setting":
        child(sys.argv[2])
        return
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    rc = 0
    for setting in SETTINGS:
        env = dict(os.environ)
        if setting == "all":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--setting", setting], env=env, timeout=600)
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
