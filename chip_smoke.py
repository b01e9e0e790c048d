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
              (reconstructions to 1e-4, digit counts exactly); prints a
              sha256 digest of the served reconstructions.
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
              first 5; prints a sha256 digest of the trained params (two
              trees give the same digest when they train to the same bits).
              The eval summaries of the trained state are finite
              wherever their slice is non-empty, and save_checkpoint /
              load_checkpoint (in a temporary directory) round-trip params,
              moments and step bit for bit. Last, two runs of the first
              DETERMINISM_STEPS steps from the same state give the same
              losses bit for bit.
  6. times    device time per launch of each kernel, its plain version and a
              PyTorch yardstick at B = 64 (CUDA graphs of back-to-back
              launches, timed with CUDA events, each launch on the next of
              as many copies of its inputs as it takes to read them from
              HBM), the bound from the published H100 SXM peaks on the
              bytes and products these inputs need (``costs``); every
              kernel (the streamed-weight resample in
              both directions, the streamed-weight write-accumulate forward
              and backward, the inline read, write, read backward and write
              backward) again at B = 1 (the demo's request), 64, 256 and
              1024 beside its yardstick; the infer latency for 1 and 64
              canvases; the train step (median of 10, host clock, each
              ending in a synchronize) through each path's kernels and
              through the plain path.
  7. trainer  the port's trainer, as ``python -m air_tpu_torch.training``
              configures it (the robust default, st_impl="inline"; both
              loops replay one captured train step), on a
              multi-MNIST set generated here from the committed digit pool
              (TRAINER_PER_STRATUM canvases per digit count, TRAINER_TEST of
              them held out) in a temporary directory. The device-data loop
              runs TRAINER_STEPS steps, TRAINER_K per host iteration, with
              evals, checkpoints and gradient summaries every
              TRAINER_EVERY steps (the trainer's main run): the kernels
              launch max_steps times per forward pass the trainer counts
              (kernels 1-4 per train step, 1-2 per eval) and no other
              kernel does; the mean loss of the last 50 steps is below that
              of the first 50; every eval accuracy is finite; the
              checkpoints, the summary JSONL and a PNG exist. Resuming from
              the step-200 checkpoint gives the uninterrupted run's losses
              from step 201 on and its final params bit for bit. The host
              loop runs TRAINER_HOST_STEPS steps under the same checks.
              Prints ms/step and images/s of both loops, and the first
              call (the capture) apart.

  8. layouts  the paths of the JAX package's entry points, which take the
              ST read and write through plain products (no ST kernel may
              launch; each run is driven with the counts at 0 and read
              after).
              Serving at the JAX wrapper's defaults: ModelWrapper(config,
              params) with no layout on both shipped checkpoints
              (air-model-cnn-47500.npz, air-model-80000.npz) is
              step-parallel, answers 1, 8 and 60 canvases at the JAX
              package's bars (0.9 and 0.8), with the digit counts of a
              scan-layout wrapper of the same seed and its reconstructions
              to PATH_TOL; the CNN checkpoint at compute_dtype="bfloat16"
              keeps 0.9 (its agreement with float32 printed). Training 60
              steps with decoder_layout="stepparallel" and 60 with
              compute_dtype="bfloat16"
              (through the inline kernels): phase 5's progress rule,
              float32 params, and 10 steps twice from one state bit-equal.
              The tools: ``python -m air_tpu_torch.demo --headless 20``
              prints 20 JSON lines of headless_demo.stream's format, and
              ``python -m air_tpu_torch.embeddings`` over a test set
              generated from the digit pool writes the projector files and
              a sprite PNG that decodes (both entry points called in this
              process, as the sweep's, the generator's and the eval
              CLI's are). Then each serving path's kernels
              per infer (torch.profiler) and its latency (median of 10, 1
              and 64 canvases), beside the inline scan path's.
  9. seeds    seed-parallel training (air_tpu_torch.train.multi_seed) of
              SEEDS replicas of the robust default at full width, through
              st_impl="inline" (kernels 1-4 folded over the S*64 images),
              on phase 5's batch, each replica in the order of its own
              epoch permutation. Step 0's gradients through the kernels
              against the plain path (GRAD_TOL, every replica's leaf);
              SEEDS_STEPS steps (the phase's main run, one captured step
              replayed, SEEDS_K per call): each step launches
              kernels 1-4 max_steps times each and no other kernel, and
              every replica passes phase 5's progress rule; each replica
              against DETERMINISM_STEPS steps of the single-seed step of
              its seed (losses to SEED_LOSS_TOL relative at steps 0-1, the
              mean loss of the steps to SEED_DRIFT_TOL; the params after
              one step: ``params_apart``);
              DETERMINISM_STEPS steps twice from one state
              bit-equal; a re-initialised replica leaves the others bit-
              equal; st_impl="pallas" (kernels 5-7 folded) at step 0
              against the plain path and SEED_PALLAS_STEPS steps. Then
              ``python -m air_tpu_torch.seed_sweep`` on a set generated
              from the committed digit pool (SEEDS_PER_STRATUM canvases
              per digit count, SEEDS_TEST held out), SWEEP_ITERS steps
              with evals every SWEEP_EVERY. Every vmap runs with the
              per-replica fallback loop turned into an error.
 10. captured the train step captured as a CUDA graph and replayed
              (air_tpu_torch.train.fast_pipeline) against the eager step,
              on phase 5's batch: TRAIN_STEPS captured steps from
              create_train_state (seed 0) through st_impl "inline",
              "pallas" and "xla" give phase 5's losses and params digest
              bit for bit (xla's eager run is made here), each path's
              kernels launching max_steps times a replayed step;
              HOLD_STEPS steps under the training CLI's schedules across
              the end of its z_pres prior hold bit-equal to the eager steps,
              the prior still up to the hold's last step and moving after;
              torch.profiler names kernels 1-4 max_steps times per
              replayed step; SEEDS_STEPS eager seed-parallel steps
              bit-equal to phase 9's captured run. Then ms/step (CUDA
              events, 10 steps), images/s and the first call (with the
              capture), captured and eager, for the single-seed step and
              the seed-parallel step at S = 1, 4, 10 and 16, each beside
              one torch.profiler window of 3 steps: kernels and copies per
              step, the time one of them runs (the union of their
              intervals) over the event-timed step (the busy share, whose
              rest is the device's idle) and over the window's span (which
              the profiler's own overhead lengthens, so that share reads
              low), and their durations summed (which counts twice the
              time cuDNN's concurrent kernels overlap).
 11. parallel multi-device training (air_tpu_torch.parallel) at the robust
              default's full width on phase 5's batch, its ranks spawned
              by air_tpu_torch.parallel.launch on the one card. (a) NCCL,
              a world of one: PARALLEL_EAGER eager data-parallel steps
              bit-equal to the single-card eager steps, TRAIN_STEPS
              captured ones (make_parallel_multi_step: two graphs around
              the all-reduce) bit-equal to phases 5 and 10, ms/step of the
              captured single-card and data-parallel steps in the rank;
              ``python -m air_tpu_torch.training --data-parallel
              --n-devices 1 --device-data`` for PARALLEL_TRAINER_STEPS
              steps and again from its step-PARALLEL_RESUME_AT checkpoint,
              bit-exact. (b) gloo, 2 ranks, data axis 2: step 0 against
              the single-card step with the same draws: its all-reduced
              gradients against the mean of the single card's gradients on
              the ranks' halves of the 64 images (GRAD_TOL), against the
              whole batch no further than those halves are from it (on the
              card a product's rounding depends on its shape, and this
              model's backward amplifies it), the loss (GRAD_TOL) and the
              params after the step (phase 9's ``apart_ok``); then
              PARALLEL_STEPS captured steps; each rank launches kernels 1-4
              max_steps times a step and nothing else, both end on one
              params digest, phase 5's progress rule holds. (c) gloo, 4
              ranks, data 2 x model 2: the LSTM gate kernel and the VAE
              hidden kernels and their moments held as column halves; step
              0 with rnn_input_hoist off and on against the single-card
              step: the loss (SEED_LOSS_TOL), the params after the step
              (``apart_ok``), and the gradients (the shards against their
              columns) and their norm against the single card's halves
              (MODEL_GRAD_TOL), printed beside the single card's own
              halves-to-whole spread. Gloo on one card checks
              the algorithm; it is no speed figure, so (b)'s and (c)'s
              ranks run at once.
 12. unrolled (a) the train step at pipeline_unroll U
              (make_multi_step(pipeline_unroll=U), st_impl="inline", phase
              5's batch; every step one replay of the one-step graph) for
              U in UNROLLS: TRAIN_STEPS steps from create_train_state
              (seed 0), a first call of U steps (the capture) and one of
              the rest, give phase 10's losses and params digest,
              launching kernels 1-4 max_steps times a step; ms/step from
              CUDA events over a call of UNROLL_TIMED steps, the first
              call and the memory it reserves; the same for the
              seed-parallel step at S = 4, U = SEED_UNROLL, against phase
              9's digest. (b) the real-handwriting path, with scikit-learn
              and PIL unimportable: ``python -m
              air_tpu_torch.generate_multi_mnist --source sklearn
              --digit-slice :1400`` with a PNG background
              (images/harder_ref_textures.png), the trainer's device-data
              loop on it with ``--pipeline-unroll 4`` as phase 7 runs it
              (launches, the progress rule, a resume bit for bit), then
              ``python -m air_tpu_torch.eval_checkpoint`` on its checkpoint
              and on the shipped CNN checkpoint over the fixture (>= 0.9),
              each launching kernels 1-2 max_steps times.
 13. configs  the JAX package's BASELINE configs 4 (scaled: canvas 100,
              LSTM 512, VAE latent 100, batch 1024) and 3 (harder: 5
              attention steps, 0-3 digits, a learned background), as
              ``python -m air_tpu_torch.training`` takes their flags. (a)
              every kernel at canvas 100, window 28 against its plain
              version at B = 1024, 7 and 1 (KERNEL_TOL, SCALAR_TOL), also
              with windows larger than the canvas and off it (at canvas
              50 too; SCALAR_RANGES), its ms
              per launch at B = 1024 beside its bound, its plain version
              and its library chain, and the ptxas report of the
              run-time-size (<0, 0>) instantiations. (b) scaled, on 1024
              canvases generated from the committed pool: step 0 through
              kernels 1-4 and through kernels 5-7 against the plain path
              (phase 5's GRAD_TOL); SCALED_STEPS captured steps bit-equal
              to as many eager ones, kernels 1-4 max_steps times a step,
              the mean reconstruction loss of the last 5 below that of
              the first 5; ``python -m air_tpu_torch.eval_checkpoint``
              with the scaled flags on a checkpoint of the run (kernels
              1-2 max_steps times each); ms/step (CUDA events), images/s,
              the busy share, the first call (the capture) and the
              memory it reserves. (c) harder:
              ``python -m air_tpu_torch.generate_multi_mnist --max-digits 3
              --max-in-common 3 --bg-kind noise --bg-max-intensity 0.6``
              (600 canvases), the trainer with HARDER_FLAGS as phase 7 runs
              it (kernels 1-4 five times a step, a resume bit for bit),
              then the eval CLI (kernels 1-2 five times each). (d) each
              configuration's trained params served by ModelWrapper.infer
              through kernels 1-2 and at the wrapper's step-parallel
              default, against the plain scan (reconstructions to
              PATH_TOL, digit counts equal), with latencies for 1 and 64
              canvases (and 1024 scaled).
 14. sweep    (a) the card's draws: every draw kind of the robust default's
              forward pass (scale, shift, vae_latent, vae_out ~ N(0, 1),
              z_pres_u ~ U(0, 1)) from ``step_generator(seed, step,
              "cuda")`` over DRAW_STEPS steps at batch 64: moments within
              5 standard errors of the law, one-sample Kolmogorov-Smirnov
              tests against the law and two-sample ones against the CPU
              generator's draws at p > DRAW_P_MIN; the Concrete's logistic
              noise from the card's uniforms at both tails (frequencies
              of |L| > 2, 4, 6 against the logistic law, every value
              within its saturation); no correlation (|r| < 5 / sqrt(n))
              between consecutive steps', consecutive seeds', a stall
              restart's and the eval stream's draws; the seed-parallel
              replicas draw their single-seed streams bit for bit, and a
              redraw of one (seed, step) repeats it. (b) ``python -m
              air_tpu_torch.seed_sweep_single`` (the sequential sweep, the
              trainer's device-data loop through kernels 1-4) for
              SINGLE_SEEDS at the robust default's full width on a set
              generated from the committed pool, SINGLE_ITERS steps each
              with evals every SINGLE_EVERY, one seed with
              ``--temp-anneal`` and one with ``--scale-prior-curriculum``
              (the sweep's main run): kernels 1-4 launch max_steps times
              per forward pass the trainers ran and no other kernel does;
              results.jsonl holds each seed's in-flight row, then its
              result row; ``python -m air_tpu_torch.summarize_sweep``
              shows the results superseding the in-flight rows (and a
              seed left in flight marked so), alone and as a ``path:tag``
              union; ``python -m air_tpu_torch.ledger`` extracts each
              run's evals and final accuracy.

Then a JSON line of the kernels, the nvidia-smi line and, last, the result
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
result line is printed. Nothing is written outside air_tpu_torch/_build/ and
a temporary directory that is removed.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import hashlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from air_tpu_torch import (eval_checkpoint, generate_multi_mnist, ledger,
                           training)
from air_tpu_torch.data import (MultiMNISTConfig, generate_dataset,
                                load_digit_pool, load_test_data)
from air_tpu_torch.data.png import read_png_grey
from air_tpu_torch.data.records import write_records
from air_tpu_torch.interop import params_to_jax
from air_tpu_torch.kernels import build, st_fused, st_inline, st_pallas
from air_tpu_torch.models.air import draw_noise
from air_tpu_torch.ops.concrete import logistic_noise
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
from air_tpu_torch.ops.transformer import _axis_weight_matrix
from air_tpu_torch.parallel.collectives import take_slice
from air_tpu_torch.parallel.launch import launch
from air_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                         param_sharding, shard_batch,
                                         shard_state)
from air_tpu_torch.parallel.train_parallel import make_parallel_train_step
from air_tpu_torch.serve.model_wrapper import ModelWrapper
from air_tpu_torch.train.checkpoint import (checkpoint_arch,
                                            latest_checkpoint,
                                            load_checkpoint, load_params,
                                            save_checkpoint)
from air_tpu_torch.train.fast_pipeline import (make_multi_step,
                                               make_parallel_multi_step)
from air_tpu_torch.train.metrics import summarize_outputs
from air_tpu_torch.train.state import create_train_state, global_norm
from air_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       step_generator)
from air_tpu_torch.train.multi_seed import (EVAL_SEED,
                                            create_multi_seed_state,
                                            make_multi_seed_step,
                                            make_replica_step,
                                            multi_seed_perms, reinit_replica,
                                            replica_batch, replica_gradients,
                                            replica_noise)
from air_tpu_torch.train import trainer as trainer_module
from air_tpu_torch.train.trainer import Trainer, attempt_seed
from air_tpu_torch.tree import (path_name, tree_leaves, tree_leaves_with_path,
                                tree_unflatten)
from air_tpu_torch.utils.profiling import StepTimer

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
RAW_CKPT = os.path.join(REPO, "model", "air-model-80000.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
MODULES = (st_inline, st_pallas, st_fused)
DEVICE = "cuda"

TIME_BUDGET_S = 600.0    # half the 1200 s the script may take
KERNEL_TOL = 1e-5       # kernel vs plain version, fp32 FMA in both
SCALAR_TOL = 1e-4       # backward scalar cotangents, x max(1, |plain|)
PATH_TOL = 1e-4         # served reconstructions, kernels vs plain versions
GRAD_TOL = 1e-4         # train step 0, kernels vs plain path
MIN_ACCURACY = 0.9      # the bar of the JAX package's shipped-model test
# phase 8: the JAX package's bars for its shipped checkpoints
# (tests/test_shipped_model.py:20-40,65-89)
SERVE_BARS = {CKPT: 0.9, RAW_CKPT: 0.8}
HEADLESS_FRAMES = 20
BATCH = 64              # the serving bucket of the 60-canvas request
SWEEP_BATCHES = (1, BATCH, 256, 1024)   # phase 6's kernels by batch
SWEPT = ("pallas_attention_read", "pallas_attention_write",
         "fused_write_accumulate", "fused_write_accumulate_bwd",
         "inline_attention_read", "inline_write_accumulate",
         "inline_attention_read_bwd", "inline_write_accumulate_bwd")
CS, WS = 50, 28
# steps of the main path's training run: the JAX package at this config on
# the same 64 canvases lowers the mean reconstruction loss of the last 5
# steps by 16-24% below that of the first 5 in 60 steps (seeds 0 and 1),
# less reliably in 30-40 (PERF.md)
TRAIN_STEPS = 60
DETERMINISM_STEPS = 10
# phase 7: the trainer on a set generated from the committed digit pool
TRAINER_PER_STRATUM = 200
TRAINER_TEST = 200
TRAINER_STEPS = 300
TRAINER_K = 50
TRAINER_EVERY = 100
TRAINER_RESUME_AT = 200
TRAINER_HOST_STEPS = 20
TRAINER_MEAN_OF = 50
# phase 9: seed-parallel training
SEEDS = (0, 1, 2, 3)
SEEDS_PER_STRATUM = 200
SEEDS_TEST = 200
SEEDS_STEPS = 60
SEEDS_K = 10                 # steps per call of the seed-parallel step
SEED_LOSS_TOL = 1e-4         # replica vs single-seed run, steps 0-1, relative
# ... and their mean loss over the SEEDS_K steps: from step 2 on the runs
# part, as this model's ill-conditioned gradient (its norm swings from 400
# to 100,000 between steps) grows rounding by orders of magnitude a step
# (losses 1.2% apart at step 4 on an H100)
SEED_DRIFT_TOL = 1e-2
SEED_PALLAS_STEPS = 2
SWEEP_ITERS = 200
SWEEP_EVERY = 100
SWEEP_K = 50
SEED_TIMED = (1, 4, 10, 16)  # S of the timings
# phase 10: steps across the end of the training CLI's z_pres prior hold
HOLD_STEPS = 10
# phase 11: multi-device training, its ranks on the one card
PARALLEL_EAGER = 10          # (a) eager steps of the NCCL world of one
PARALLEL_STEPS = 30          # (b) captured steps of the gloo world of two
PARALLEL_K = 10              # (b) steps per call
PARALLEL_TRAINER_STEPS = 40  # (a) the driver's run, resumed from the middle
PARALLEL_RESUME_AT = 20
RANK_SECONDS = 600           # the limit of each launch of ranks
# (c) step 0's gradients and their norm on data 2 x model 2 against the
# single card's on the ranks' halves: the card read 5.0e-3-1.0e-2 (a
# column-sliced product rounds otherwise, and the BCE's 1 / (x + 1e-9)
# amplifies it); a gradient of the right sign and the wrong size (a x2
# in the model axis's backward) reads O(1)
MODEL_GRAD_TOL = 5e-2
# the kernels each path launches: (forward, backward)
PATHS = {
    "inline": (("inline_attention_read", "inline_write_accumulate"),
               ("inline_attention_read_bwd", "inline_write_accumulate_bwd")),
    "pallas": (("pallas_attention_read", "fused_write_accumulate"),
               ("fused_write_accumulate_bwd",)),
}
# kernels 1-4 by the names the card's profiler gives them
INLINE_SYMBOLS = {"inline_attention_read": "st_read_kernel",
                  "inline_write_accumulate": "st_write_kernel",
                  "inline_attention_read_bwd": "st_read_bwd_kernel",
                  "inline_write_accumulate_bwd": "st_write_bwd_kernel"}
# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
# phase 12: pipeline_unroll and the real-handwriting path
UNROLLS = (1, 2, 4, 10, 50)
UNROLL_TIMED = 100           # steps of the timed call
SEED_UNROLL = 4
REAL_PER_STRATUM = 200
REAL_TEST = 100
REAL_SLICE = ":1400"         # the UCI digits the real set draws from
REAL_BG = os.path.join(REPO, "images", "harder_ref_textures.png")
# phase 13: the JAX package's BASELINE configs 4 (scaled) and 3 (harder), as
# python -m air_tpu_torch.training takes them (bench.py:get_config;
# RESULTS.md, "Round-4 scaled config trains"; scripts/run_bg_r4.sh)
SCALED_CS = 100
SCALED_BATCH = 1024
SCALED_FLAGS = ["--canvas-size", "100", "--rnn-units", "512", "--vae-latent",
                "100", "--batch-size", str(SCALED_BATCH), "--anneal-iters",
                "190", "--anneal-hold", "940"]
SCALED_KERNEL_BATCHES = (SCALED_BATCH, 7, 1)
SCALED_STEPS = 20            # eager and captured steps of the scaled step
SCALED_MEAN_OF = 5
HARDER_FLAGS = ["--max-steps", "5", "--max-digits", "3",
                "--learn-background", "--bg-init", "data"]
HARDER_DATA = ["--max-digits", "3", "--max-in-common", "3",
               "--bg-kind", "noise", "--bg-max-intensity", "0.6"]
HARDER_PER_STRATUM = 150     # 0-3 digits: 600 canvases, 100 held out
HARDER_TEST = 100
DRAW_STEPS = 200             # (seed, step) streams of phase 14 (a)
DRAW_KEEP = {"scale": DRAW_STEPS, "shift": DRAW_STEPS,
             "z_pres_u": DRAW_STEPS, "vae_latent": 20, "vae_out": 2}
DRAW_P_MIN = 1e-3
SINGLE_SEEDS = ((0, "--temp-anneal"), (1, "--scale-prior-curriculum"))
SINGLE_ITERS = 300
SINGLE_EVERY = 100
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20      # the H100's L2 cache
ROTATE_MAX = 512             # copies of the inputs timed launches take in turn
# the window scalars of the kernel checks: (s range, bound of |x| and |y|);
# "smoke" is every phase's, the others windows larger than the canvas and
# partly or wholly off it, as training can move them (phase 13 (a))
SCALAR_RANGES = {"smoke": ((0.1, 1.0), 1.0), "wide": ((0.05, 3.0), 2.5),
                 "off-canvas": ((0.1, 0.6), 4.0)}

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


def digest(arrays) -> str:
    """A short hash of the arrays' bytes: two runs print the same digest
    when every value is the same bit for bit."""
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().reshape(-1).view(torch.uint8).numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def scalars(b: int, gen: torch.Generator, scalar_range: str = "smoke"):
    """s, x and y uniform in SCALAR_RANGES[scalar_range] (smoke: s in
    [0.1, 1], x and y in [-1, 1])."""
    (lo, hi), span = SCALAR_RANGES[scalar_range]
    u = torch.rand((3, b), generator=gen, device=DEVICE)
    return (lo + (hi - lo) * u[0], span * (2.0 * u[1] - 1.0),
            span * (2.0 * u[2] - 1.0))


def kernel_inputs(b: int, seed: int, cs: int = CS, ws: int = WS,
                  scalar_range: str = "smoke") -> dict:
    """Random operands of the kernels at canvas cs and window ws."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    s, x, y = scalars(b, gen, scalar_range)
    return dict(
        img=torch.rand((b, cs, cs), generator=gen, device=DEVICE),
        win=torch.rand((b, ws, ws), generator=gen, device=DEVICE),
        canvas=torch.rand((b, cs * cs), generator=gen, device=DEVICE),
        coeff=torch.rand((b,), generator=gen, device=DEVICE),
        s=s, x=x, y=y)


def core_inputs(d: dict, seed: int) -> dict:
    """The per-axis scalars (a, c) as the inline wrappers form them from
    (s, x, y), the dense weight matrices [B, out, in] the streamed-weight
    wrappers build from them, and random output cotangents of the read
    [B, ws, ws] and of the write [B, cs, cs]."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    b, cs, ws = d["s"].shape[0], d["img"].shape[-1], d["win"].shape[-1]
    inv_s = 1.0 / d["s"]
    read = (d["s"], d["y"], d["s"], d["x"])
    write = (inv_s, -d["y"] * inv_s, inv_s, -d["x"] * inv_s)
    return dict(
        read=read, write=write,
        w_read=(_axis_weight_matrix(read[0], read[1], ws, cs),
                _axis_weight_matrix(read[2], read[3], ws, cs)),
        w_write=(_axis_weight_matrix(write[0], write[1], cs, ws),
                 _axis_weight_matrix(write[2], write[3], cs, ws)),
        g_read=torch.randn((b, ws, ws), generator=gen, device=DEVICE),
        g_write=torch.randn((b, cs, cs), generator=gen, device=DEVICE))


def canvas3(d):
    cs = d["img"].shape[-1]
    return d["canvas"].reshape(-1, cs, cs)


# each kernel: (its wrapper, its plain version, the number of matrix
# outputs before the scalar ones), all on the inputs of kernel_inputs and
# core_inputs
KERNELS = {
    "inline_attention_read": (
        lambda d, e: st_inline.attention_read_fwd(d["img"], *e["read"],
                                                  d["win"].shape[-1]),
        lambda d, e: st_inline.attention_read_fwd_plain(
            d["img"], *e["read"], d["win"].shape[-1]), 1),
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


def kernel_errors(batches, cs: int, ws: int, seed: int, phase: str,
                  card_line: str, scalar_range: str = "smoke") -> dict:
    """Every kernel against its plain version on the same inputs at each
    batch of ``batches``, canvas cs and window ws, the window scalars drawn
    from SCALAR_RANGES[scalar_range]; fails beyond KERNEL_TOL (values,
    matrix cotangents) or SCALAR_TOL (scalar cotangents), and prints the
    largest differences. Returns each kernel's largest matrix difference."""
    err = {k: 0.0 for k in KERNELS}
    scalar_err = {k: 0.0 for k in KERNELS}
    for b in batches:
        d = kernel_inputs(b, seed + b, cs, ws, scalar_range)
        e_in = core_inputs(d, seed + 100 + b)
        for kname, (got_fn, want_fn, n_mat) in KERNELS.items():
            got = got_fn(d, e_in)
            torch.cuda.synchronize()
            want = want_fn(d, e_in)
            torch.cuda.synchronize()
            mat, scal = errors(got, want, n_mat)
            err[kname] = max(err[kname], mat)
            scalar_err[kname] = max(scalar_err[kname], scal)
            if not (mat <= KERNEL_TOL and scal <= SCALAR_TOL):
                fail(f"{kname} at B={b}, ({cs}, {ws}), {scalar_range} "
                     f"scalars: matrix max abs diff "
                     f"{mat} (tol {KERNEL_TOL}), scalar rel diff {scal} (tol "
                     f"{SCALAR_TOL})")
    say(phase, card_line, "kernel vs plain max abs diff "
        + " ".join(f"{k}={v:.3g}" for k, v in err.items())
        + f" (tol {KERNEL_TOL}); backward scalar cotangents |diff| / "
        "max(1, |plain|) "
        + " ".join(f"{k}={v:.3g}" for k, v in scalar_err.items()
                   if k.endswith("_bwd"))
        + f" (tol {SCALAR_TOL}); B={','.join(map(str, batches))}"
        + ("" if (cs, ws) == (CS, WS) else f" at canvas {cs}, window {ws}")
        + ("" if scalar_range == "smoke" else
           f"; {scalar_range} window scalars (s in "
           f"{list(SCALAR_RANGES[scalar_range][0])}, |x|, |y| <= "
           f"{SCALAR_RANGES[scalar_range][1]})"))
    return err


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


def device_ms(fns, reps: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fns`` (a callable, or a list of callables
    called in turn): at least ``reps`` back-to-back calls, as many of each,
    captured in one CUDA graph, replayed ``replays`` times between two CUDA
    events, so the host's launch overhead is not in the number."""
    fns = fns if isinstance(fns, list) else [fns]
    calls = fns * -(-reps // len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
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
    return start.elapsed_time(end) / (len(calls) * replays)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rotation(nbytes: float, available: int) -> int:
    """How many copies of a kernel's inputs its timed launches take in turn:
    enough that the launches between two reads of one copy move twice the
    L2 cache, so that each launch reads its inputs from HBM, as its bound
    and a caller whose batch outgrows the cache find them; at most
    ``available``."""
    return min(available, 1 + -(-2 * L2_BYTES // int(nbytes)))


def _copy(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    return {k: _copy(x) for k, x in v.items()}


def input_sets(b: int, seed: int, core_seed: int, cs: int = CS,
               ws: int = WS) -> list:
    """The kernels' timed inputs at batch b, canvas cs and window ws:
    kernel_inputs(b, seed) and core_inputs(.., core_seed), and copies of
    them (the same values at other addresses), as many as the kernel of the
    fewest bytes rotates over (``rotation``, at most ROTATE_MAX). A list of
    (d, e, the Library of d and e)."""
    d = kernel_inputs(b, seed, cs, ws)
    e = core_inputs(d, core_seed)
    n = max(rotation(nbytes, ROTATE_MAX) for nbytes, _ in costs(d, e).values())
    sets = [(d, e)] + [(_copy(d), _copy(e)) for _ in range(n - 1)]
    return [(d, e, Library(d, e)) for d, e in sets]


def kernel_times(kname: str, sets: list) -> dict:
    """Kernel ``kname`` on ``sets`` (input_sets): device ms per launch of
    the kernel, of its plain version and of its library chain, each launch
    taking the next of ``rotation`` copies of the inputs; and its bound
    from ``costs`` on these inputs."""
    fn, plain_fn, _ = KERNELS[kname]
    nbytes, flops = costs(*sets[0][:2])[kname]
    b_ms, b_by = bound_ms(nbytes, flops)
    use = sets[:rotation(nbytes, len(sets))]
    t = {"ms": device_ms([functools.partial(fn, d, e) for d, e, _ in use]),
         "plain_ms": device_ms([functools.partial(plain_fn, d, e)
                                for d, e, _ in use]),
         "library_ms": library_ms([lib for _, _, lib in use], kname),
         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
         "copies": len(use),
         "from_hbm": (len(use) - 1) * nbytes >= 2 * L2_BYTES}
    if t["from_hbm"] and t["ms"] < t["bound_ms"]:
        fail(f"{kname} took {t['ms']} ms a launch, below its bound "
             f"{b_ms} ms: costs counts more than the function needs")
    return t


def times_line(t: dict) -> str:
    return (f"ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} library_ms="
            f"{t['library_ms']:.5f} ms/library={t['ms'] / t['library_ms']:.3f}"
            f" bound_ms={t['bound_ms']:.6f} ({t['bound_by']}; "
            f"{t['bytes']:.0f} B, {t['flops']:.0f} FLOP) ms/bound="
            f"{t['ms'] / t['bound_ms']:.2f}; {t['copies']} copies of the "
            "inputs in turn, " + ("each read from HBM" if t["from_hbm"] else
                                  "fewer than the L2 cache holds"))


def _touched(wy: torch.Tensor, wx: torch.Tensor, canvas_dim: int) -> tuple:
    """Per item of a pair of [B, out, in] hat-weight matrices whose dim
    ``canvas_dim`` runs over the canvas: the canvas rows it touches, the
    canvas columns, and the nonzero taps of wy and of wx (float64 [B])."""
    other = 3 - canvas_dim
    return ((wy != 0).any(dim=other).sum(-1).double(),
            (wx != 0).any(dim=other).sum(-1).double(),
            (wy != 0).sum((1, 2)).double(), (wx != 0).sum((1, 2)).double())


def costs(d: dict, e: dict) -> dict:
    """(bytes, FLOP) of each kernel's function on the inputs of
    kernel_inputs ``d`` and core_inputs ``e``, for its bound: each input
    read once and each output written once, as far as these inputs need
    them. An item's hat weights touch a band of the canvas's rows and
    columns (the window's scale and place set it) with at most two taps a
    row: a canvas-side input that reaches the outputs only through them
    (the image of a read, the output cotangent of a write) is counted on
    the rows and columns they touch, and a product on its nonzero taps.
    Outputs are counted whole, and so are the window side and the
    streamed kernels' [B, out, in] weight matrices, which are inputs."""
    f32 = 4
    cs, ws = d["img"].shape[-1], d["win"].shape[-1]
    rr, cr, nyr, nxr = _touched(*e["w_read"], canvas_dim=2)
    rw, cw, nyw, nxw = _touched(*e["w_write"], canvas_dim=1)
    read_macs = nxr * rr + nyr * ws          # img Wx^T on the touched rows,
    #                                          then Wy on the taps
    write_macs = nxw * ws + nyw * cw         # win Wx^T, then Wy on the taps
    per_item = {
        "inline_attention_read": (rr * cr + 4 + ws * ws, read_macs),
        "inline_write_accumulate": (2 * cs * cs + ws * ws + 5,
                                    write_macs + rw * cw),
        # d_img = Wy^T g Wx, then the taps of dWy (through img Wx^T) and of
        # dWx (through Wy img) that the four scalar cotangents take
        "inline_attention_read_bwd": (
            rr * cr + ws * ws + 4 + cs * cs + 4,
            ws * nxr + nyr * cr + read_macs + nyr * cr + nxr * ws),
        # d_win = coeff Wy^T g Wx on the touched rows, the taps of dWy
        # (through win Wx^T) and of dWx (through Wy win), and d_coeff
        "inline_write_accumulate_bwd": (
            2 * ws * ws + rw * cw + 5 + 5,
            nxw * rw + nyw * ws + write_macs + nyw * ws + nxw * rw + rw * cw),
        "pallas_attention_read": (rr * cr + 2 * ws * cs + ws * ws, read_macs),
        "pallas_attention_write": (ws * ws + 2 * cs * ws + cs * cs,
                                   write_macs),
        "fused_write_accumulate": (2 * cs * ws + ws * ws + 1 + 2 * cs * cs,
                                   write_macs + rw * cw),
        # dWy and dWx are dense outputs: dWy takes g's touched columns on
        # every row, dWx its touched rows on every column
        "fused_write_accumulate_bwd": (
            ws * ws + 2 * cs * ws + 1 + (cs * cw + rw * cs - rw * cw)
            + 2 * cs * ws + ws * ws + 1,
            nxw * ws + cs * ws * cw + nyw * ws + cs * ws * rw + rw * nxw
            + nyw * ws + rw * cw),
    }
    zero = torch.zeros_like(rr)              # [B]: sums a count over items
    return {k: (f32 * float((nb + zero).sum()), 2 * float((m + zero).sum()))
            for k, (nb, m) in per_item.items()}


class Library:
    """The PyTorch yardstick of each kernel on one batch of inputs: a batched
    matmul chain with the weights prebuilt; of a backward,
    torch.autograd.grad through it with respect to the input and both
    weights (no scalar contraction, and for the streamed write no d_coeff),
    timed as forward + grad less the forward."""

    def __init__(self, d: dict, e: dict):
        (wy_r, wx_r), (wy_w, wx_w) = e["w_read"], e["w_write"]
        self.d, self.e = d, e
        self.leaves_r = [t.detach().clone().requires_grad_(True)
                         for t in (d["img"], wy_r, wx_r.transpose(1, 2))]
        self.leaves_w = [t.detach().clone().requires_grad_(True)
                         for t in (d["win"], wy_w * d["coeff"][:, None, None],
                                   wx_w.transpose(1, 2))]
        self.plain_write = (wy_w.detach(), wx_w.detach().transpose(1, 2))

    def read_fwd(self):
        r = self.leaves_r
        return torch.matmul(torch.matmul(r[1], r[0]), r[2])

    def write_fwd(self):
        w = self.leaves_w
        return torch.baddbmm(canvas3(self.d), torch.bmm(w[1], w[0]), w[2])

    def read_bwd(self):
        return torch.autograd.grad(self.read_fwd(), self.leaves_r,
                                   self.e["g_read"])

    def write_bwd(self):
        return torch.autograd.grad(self.write_fwd(), self.leaves_w,
                                   self.e["g_write"])

    def resample_write(self):
        wy, wx_t = self.plain_write
        return torch.bmm(torch.bmm(wy, self.d["win"]), wx_t)

    def chain(self, kname: str) -> tuple:
        """(the yardstick of kernel ``kname``, the forward to take off its
        time or None)."""
        return {
            "inline_attention_read": (self.read_fwd, None),
            "inline_write_accumulate": (self.write_fwd, None),
            "inline_attention_read_bwd": (self.read_bwd, self.read_fwd),
            "inline_write_accumulate_bwd": (self.write_bwd, self.write_fwd),
            "pallas_attention_read": (self.read_fwd, None),
            "pallas_attention_write": (self.resample_write, None),
            "fused_write_accumulate": (self.write_fwd, None),
            "fused_write_accumulate_bwd": (self.write_bwd, self.write_fwd),
        }[kname]


def library_ms(libs: list, kname: str) -> float:
    """Device ms of the yardstick of kernel ``kname``, each call on the next
    Library of ``libs``."""
    chains = [lib.chain(kname) for lib in libs]
    t = device_ms([fn for fn, _ in chains])
    if chains[0][1] is None:
        return t
    return t - device_ms([less for _, less in chains])


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
        f"(tol {PATH_TOL}) reconstructions_sha256="
        f"{digest(r for got in served for r in got[2])}")
    return wrapper


def check_train(config, state0, images, digits, card_line: str) -> tuple:
    """Phase 5 for the path of ``config.st_impl``. Returns the launches of
    each of the path's kernels over its TRAIN_STEPS steps, and the run's
    losses and params digest."""
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
    say("train", card_line, f"st_impl={impl} step 0 kernels vs plain path: "
        + against_plain(impl, m_k, m_p))

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
        f"moved; params_sha256={digest(tree_leaves(state.params))}")

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

    trained = state
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
    return main_launches, (losses, digest(tree_leaves(trained.params)))


def against_plain(impl: str, m_k: dict, m_p: dict) -> str:
    """Fail unless a step through the ``impl`` kernels (metrics ``m_k``,
    with gradients) agrees with the plain path's step on the same params
    and draws (``m_p``): the loss and grad_norm to GRAD_TOL relative, every
    gradient leaf to GRAD_TOL x max(1, max |leaf|). Returns the line that
    says how far they are apart."""
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
    return (f"loss {float(m_k['loss']):.4f} vs {float(m_p['loss']):.4f} (rel "
            f"{rel['loss']:.3g}), grad_norm rel {rel['grad_norm']:.3g}, "
            f"gradient leaves max |diff| / max(1, max |leaf|) "
            f"{grad_err:.3g} (tol {GRAD_TOL})")


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


def trainer_run(argv: list, log_path: str) -> tuple:
    """A Trainer configured by ``python -m air_tpu_torch.training``'s flags,
    trained with its stdout in ``log_path``. Returns (trainer, result)."""
    args = training.build_parser().parse_args(["--device", DEVICE, *argv])
    model_config, trainer_config = training.configs(args)
    test = load_test_data(args.test_data, shift_zero_digits_images=True)
    with open(log_path, "a") as log, contextlib.redirect_stdout(log):
        trainer = Trainer(model_config, trainer_config, args.train_data, test)
        result = trainer.train()
    torch.cuda.synchronize()
    return trainer, result


def records(trainer, prefix: str) -> dict:
    """{step: record} of the trainer's JSONL lines that hold ``prefix``."""
    out = {}
    with open(trainer.metrics.path) as f:
        for line in f:
            rec = json.loads(line)
            if any(k.startswith(prefix) for k in rec):
                out[rec["step"]] = rec
    return out


def expect_trainer_launches(trainer, what: str) -> dict:
    """Fail unless, since the last reset, kernels 1-4 launched max_steps
    times per forward pass the trainer ran (the backward kernels per train
    and gradient step, the forward ones per eval too) and no other kernel
    did. Returns the inline kernels' counts."""
    t = trainer.config.max_steps
    steps = trainer.calls["train"] + trainer.calls["grad"]
    fwd, bwd = PATHS["inline"]
    want = {**{k: t * (steps + trainer.calls["eval"]) for k in fwd},
            **{k: t * steps for k in bwd}}
    expect_launches({k: 0 for k in launches()}, want,
                    f"{what} ({dict(trainer.calls)} forward passes)")
    return want


def trainer_and_resume(phase: str, data: str, extra: list, tmp: str,
                       log: str, card_line: str) -> dict:
    """The trainer's device-data loop on the set in ``data``, as ``python
    -m air_tpu_torch.training`` configures it with ``extra`` flags:
    TRAINER_STEPS steps, TRAINER_K per host iteration, evals, checkpoints
    and gradient summaries every TRAINER_EVERY steps (the main run, held
    to its launches, the progress rule, finite evals, its files), then a
    run resumed from its step-TRAINER_RESUME_AT checkpoint, held to its
    losses and params bit for bit. Returns the main run's launches."""
    common = ["--train-data", os.path.join(data, "common.airrec"),
              "--test-data", os.path.join(data, "test.airrec"),
              "--log-every", "1"]
    device_loop = [*common, "--device-data",
                   "--multi-step", str(TRAINER_K),
                   "--eval-every", str(TRAINER_EVERY),
                   "--save-every", str(TRAINER_EVERY),
                   "--grad-every", str(TRAINER_EVERY),
                   "--img-every", str(TRAINER_STEPS), *extra]
    flags = " ".join(extra)
    with_flags = f", {flags}" if flags else ""
    run_a = os.path.join(tmp, phase + "_a")
    reset_launches()
    trainer, result = trainer_run(
        [*device_loop, "--results-folder", run_a,
         "--steps", str(TRAINER_STEPS)], log)
    main_launches = expect_trainer_launches(trainer, "the device-data loop")
    train = records(trainer, "train/")
    losses = [train[s]["train/loss"] for s in range(1, TRAINER_STEPS + 1)]
    first = float(np.mean(losses[:TRAINER_MEAN_OF]))
    last = float(np.mean(losses[-TRAINER_MEAN_OF:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        fail(f"trainer {flags}: mean loss of the last {TRAINER_MEAN_OF} "
             f"steps {last} not below that of the first {TRAINER_MEAN_OF} "
             f"{first}, or a loss is not finite")
    evals = {s: r["test/accuracy"]
             for s, r in records(trainer, "test/").items()}
    if (sorted(evals) != list(range(0, TRAINER_STEPS + 1, TRAINER_EVERY))
            or not np.all(np.isfinite(list(evals.values())))):
        fail(f"trainer {flags}: eval accuracies {evals}")
    saved = [f"air-model-{s}.npz" for s in evals]
    missing = [f for f in saved if not os.path.exists(
        os.path.join(trainer.models_dir, f))]
    png = os.path.join(trainer.summary_dir,
                       f"reconstruction_{TRAINER_STEPS}.png")
    if missing or not os.path.exists(png):
        fail(f"trainer {flags}: missing checkpoints {missing} or {png}")
    params_a = digest(tree_leaves(trainer.state.params))
    say(phase, card_line, f"device-data loop (K={TRAINER_K}{with_flags}) "
        f"{TRAINER_STEPS} steps: launches={main_launches} for "
        f"{dict(trainer.calls)} forward passes; loss mean of first "
        f"{TRAINER_MEAN_OF} {first:.3f}, last {TRAINER_MEAN_OF} "
        f"{last:.3f}; eval accuracy "
        + " ".join(f"@{s}={a:.4f}" for s, a in evals.items())
        + f"; checkpoints {saved}, metrics.jsonl and a PNG written; "
        f"params_sha256={params_a}")
    say(phase, card_line, f"device-data loop (captured step{with_flags}): "
        f"{result['ms_per_step']:.3f} ms/step in the train steps, "
        f"{BATCH / result['ms_per_step'] * 1e3:.1f} images/s; "
        f"{result['steady_ms_per_step']:.3f} ms/step after the first "
        f"chunk, which took {result['first_call_ms']:.1f} ms with the "
        f"capture (StepTimer); {result['images_per_sec']:.1f} images/s "
        f"over the whole run, events included")

    # resume from the step-TRAINER_RESUME_AT checkpoint of the main run
    run_b = os.path.join(tmp, phase + "_b")
    os.makedirs(os.path.join(run_b, "models"))
    for ext in (".npz", ".json"):
        shutil.copy(os.path.join(trainer.models_dir,
                                 f"air-model-{TRAINER_RESUME_AT}{ext}"),
                    os.path.join(run_b, "models"))
    resumed, _ = trainer_run(
        [*device_loop, "--results-folder", run_b,
         "--steps", str(TRAINER_STEPS)], log)
    again = records(resumed, "train/")
    tail = range(TRAINER_RESUME_AT + 1, TRAINER_STEPS + 1)
    params_b = digest(tree_leaves(resumed.state.params))
    if (resumed.folder != run_b
            or [again.get(s, {}).get("train/loss") for s in tail]
            != [train[s]["train/loss"] for s in tail]
            or params_b != params_a):
        fail(f"trainer {flags}: resuming from step {TRAINER_RESUME_AT} "
             "does not repeat the uninterrupted run (losses or params)")
    say(phase, card_line, f"resumed from the step-{TRAINER_RESUME_AT} "
        f"checkpoint: loss at step {TRAINER_RESUME_AT + 1} "
        f"{again[TRAINER_RESUME_AT + 1]['train/loss']!r} and every loss to "
        f"step {TRAINER_STEPS} bit-equal to the uninterrupted run; "
        f"params_sha256={params_b}")
    return main_launches, trainer


def show_log(path: str) -> None:
    """The end of a trainer's log on stderr, if it was written."""
    if os.path.exists(path):
        with open(path) as f:
            sys.stderr.write(f.read()[-6000:])


def check_trainer(card_line: str) -> dict:
    """Phase 7. Returns the inline kernels' launches in the trainer's main
    run (the device-data loop)."""
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        pool, labels = load_digit_pool()
        data = os.path.join(tmp, "data")
        generate_dataset(pool, labels, MultiMNISTConfig(
            images_per_digit=TRAINER_PER_STRATUM, test_set_size=TRAINER_TEST,
            seed=0), out_dir=data)
        say("trainer", card_line, f"generated {3 * TRAINER_PER_STRATUM} "
            f"canvases ({TRAINER_TEST} held out) from the committed pool of "
            f"{len(pool)} digits in {time.perf_counter() - t:.1f} s")
        log = os.path.join(tmp, "trainer.log")
        try:
            main_launches, _ = trainer_and_resume("trainer", data, [], tmp,
                                                  log, card_line)
            # the host loop
            reset_launches()
            host, result = trainer_run(
                ["--train-data", os.path.join(data, "common.airrec"),
                 "--test-data", os.path.join(data, "test.airrec"),
                 "--log-every", "1",
                 "--results-folder", os.path.join(tmp, "c"),
                 "--steps", str(TRAINER_HOST_STEPS), "--eval-every", "10",
                 "--save-every", "10", "--grad-every", "10",
                 "--img-every", "10"], log)
            host_launches = expect_trainer_launches(host, "the host loop")
            losses = [r["train/loss"]
                      for r in records(host, "train/").values()]
            if (len(losses) != TRAINER_HOST_STEPS
                    or not np.all(np.isfinite(losses))
                    or host.state.step != TRAINER_HOST_STEPS
                    or latest_checkpoint(host.models_dir) is None):
                fail(f"trainer: host loop losses {losses}")
            say("trainer", card_line, f"host loop {TRAINER_HOST_STEPS} "
                f"steps: launches={host_launches} for {dict(host.calls)} "
                f"forward passes; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
                f"{result['ms_per_step']:.3f} ms/step in the captured train "
                f"steps, {BATCH / result['ms_per_step'] * 1e3:.1f} images/s; "
                f"{result['steady_ms_per_step']:.3f} ms/step after the "
                f"first, which took {result['first_call_ms']:.1f} ms with "
                f"the capture")
        except BaseException:
            show_log(log)
            raise
    return main_launches


def infer_latency(wrapper, canvases, n: int, runs: int = 10) -> float:
    """Median host ms of one infer call of n canvases (it ends in a
    device-to-host copy)."""
    req = canvases[np.arange(n) % len(canvases)]
    wrapper.infer(req)
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        wrapper.infer(req)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def profiled_window(fn, calls: int = 3) -> dict:
    """What the card runs per call of ``fn`` (after one call to warm up),
    from one torch.profiler window of the card's activity over ``calls``
    calls: ``kernels``, its kernels and copies; ``busy_ms``, the time at
    least one of them runs (the union of their intervals); ``window_ms``,
    the span from the first one's start to the last one's end;
    ``summed_ms``, their durations summed, which counts twice the time two
    of them overlap (cuDNN runs some of its kernels on streams of its own,
    inside a graph too). ``busy_ms <= window_ms`` by construction."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = device_spans(prof)
    if not spans:
        fail("torch.profiler recorded no kernel on the card")
    busy, end = 0, spans[0][0]
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernels": len(spans) / calls,
            "busy_ms": busy / calls / 1e6,
            "window_ms": (end - spans[0][0]) / calls / 1e6,
            "summed_ms": sum(b - a for a, b, _ in spans) / calls / 1e6}


def device_spans(prof) -> list:
    """(start ns, end ns, name) of each kernel and copy a profile recorded
    on the card, by start (its ranges' device-side rows left out), from
    the profiler's raw events."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation())


def busy_line(t: dict) -> str:
    """``profiled_window``'s counts per step beside the event-timed
    ``ms``, as phase 10 prints them: the busy share is busy_ms / ms (its
    rest the device's idle); the share of the profiled span, which the
    profiler's own overhead lengthens, stands beside it."""
    return (f"{t['kernels']:.0f} kernels and copies per step; "
            f"torch.profiler: {t['busy_ms']:.3f} ms busy a step, "
            f"{t['busy_ms'] / t['ms']:.1%} of the event-timed step (busy "
            f"share); in the profiled span of {t['window_ms']:.3f} ms a "
            f"step, lengthened by the profiler, "
            f"{t['busy_ms'] / t['window_ms']:.1%}; kernel durations summed "
            f"{t['summed_ms']:.3f} ms")


def kernels_per_infer(wrapper, canvases, n: int, calls: int = 3) -> float:
    """Kernels and copies the card runs per infer call of n canvases."""
    req = canvases[np.arange(n) % len(canvases)]
    return profiled_window(lambda: wrapper.infer(req), calls)["kernels"]


def check_default_serving(canvases, truth, card_line: str) -> dict:
    """Phase 8, serving: both shipped checkpoints through the wrapper's
    default layout, and the CNN one at bfloat16. Returns the wrappers."""
    requests = [canvases[:1], canvases[:8], canvases]
    wrappers = {}
    for path, bar in SERVE_BARS.items():
        name = os.path.basename(path)
        config = DEFAULT_TRAINING_CONFIG.replace(**checkpoint_arch(path))
        params = load_params(path)
        wrapper = ModelWrapper(config, params, seed=0, device=DEVICE)
        if wrapper.config.decoder_layout != "stepparallel":
            fail(f"{name}: the default wrapper's layout is "
                 f"{wrapper.config.decoder_layout}, not stepparallel")
        scan = ModelWrapper(config, params, seed=0, decoder_layout="scan",
                            device=DEVICE)
        reset_launches()
        served = [wrapper.infer(req) for req in requests]
        torch.cuda.synchronize()
        expect_launches({k: 0 for k in launches()}, {},
                        f"{name} step-parallel serving")
        err = 0.0
        for req, got in zip(requests, served):
            want = scan.infer(req)
            if list(got[0]) != list(want[0]):
                fail(f"{name}: step-parallel digit counts differ from the "
                     f"scan layout's on {len(req)} canvases")
            err = max(err, max(float(np.max(np.abs(a - b)))
                               for a, b in zip(got[2], want[2])))
            if not all(np.all(np.isfinite(r)) for r in got[2]):
                fail(f"{name}: non-finite reconstructions")
        if not err <= PATH_TOL:
            fail(f"{name}: step-parallel reconstructions differ from the "
                 f"scan layout's by {err}")
        accuracy = float(np.mean(np.asarray(served[-1][0]) == truth))
        if accuracy < bar:
            fail(f"{name}: step-parallel accuracy {accuracy} < {bar}")
        say("layouts", card_line, f"serve {name} at the wrapper's default "
            f"(decoder_layout=stepparallel, st_impl=xla): requests "
            f"{[len(r) for r in requests]}, ST kernel launches 0, accuracy "
            f"{accuracy:.4f} (bar {bar}), digit counts equal to the scan "
            f"layout's, reconstructions vs scan max abs {err:.3g} (tol "
            f"{PATH_TOL}) reconstructions_sha256="
            f"{digest(r for got in served for r in got[2])}")
        wrappers[name] = wrapper

    config = DEFAULT_TRAINING_CONFIG.replace(**checkpoint_arch(CKPT),
                                             compute_dtype="bfloat16")
    bf16 = ModelWrapper(config, load_params(CKPT), seed=0, device=DEVICE)
    reset_launches()
    digits16 = bf16.infer(canvases)[0]
    torch.cuda.synchronize()
    expect_launches({k: 0 for k in launches()}, {}, "bfloat16 serving")
    accuracy = float(np.mean(np.asarray(digits16) == truth))
    digits32 = wrappers[os.path.basename(CKPT)].infer(canvases)[0]
    agree = float(np.mean(np.asarray(digits16) == np.asarray(digits32)))
    if accuracy < MIN_ACCURACY:
        fail(f"bfloat16 serving accuracy {accuracy} < {MIN_ACCURACY}")
    say("layouts", card_line, f"serve {os.path.basename(CKPT)} at "
        f"compute_dtype=bfloat16 (stepparallel): accuracy {accuracy:.4f}, "
        f"digit counts equal to float32 serving on {agree:.4f} of "
        f"{len(canvases)} canvases")
    wrappers["bfloat16 " + os.path.basename(CKPT)] = bf16
    return wrappers


def check_layout_train(name: str, config, state0, images, digits,
                       card_line: str) -> None:
    """Phase 8, training: TRAIN_STEPS steps through ``config``'s layout
    under phase 5's checks, and DETERMINISM_STEPS twice from one state."""
    impl, steps = config.st_impl, config.max_steps
    per_step = ({k: steps for k in PATHS[impl][0] + PATHS[impl][1]}
                if impl in PATHS else {})
    train_step = make_train_step(config)
    state, losses, recons = state0, [], []
    reset_launches()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = launches()
        state, m = train_step(state, images, digits)
        expect_launches(before, per_step, f"{name} train step {i}")
        losses.append(float(m["loss"]))
        recons.append(float(m["reconstruction_loss"]))
    seconds = time.perf_counter() - t0
    main_launches = {k: launches()[k] for k in per_step}
    if not np.all(np.isfinite(losses)):
        fail(f"{name}: non-finite training loss: {losses}")
    leaves = list(zip(tree_leaves_with_path(state.params),
                      tree_leaves(state0.params)))
    still = [p for (p, a), b in leaves if torch.equal(a, b)]
    not_f32 = [p for (p, a), _ in leaves if a.dtype != torch.float32]
    if still or not_f32:
        fail(f"{name}: leaves that did not move {still}, or not float32 "
             f"{not_f32}")
    first5, last5 = float(np.mean(recons[:5])), float(np.mean(recons[-5:]))
    if not last5 < first5:
        fail(f"{name}: mean reconstruction loss of the last 5 steps {last5} "
             f"is not below that of the first 5 {first5}")
    runs = []
    for _ in range(2):
        s, bits = state0, []
        for _ in range(DETERMINISM_STEPS):
            s, m = train_step(s, images, digits)
            bits.append(m["loss"].view(torch.int32).item())
        runs.append(bits)
    if runs[0] != runs[1]:
        fail(f"{name}: two runs of {DETERMINISM_STEPS} steps from the same "
             "state part")
    say("layouts", card_line, f"train {name}: {TRAIN_STEPS} steps in "
        f"{seconds:.2f} s, ST kernel launches {main_launches}, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}, reconstruction loss mean of "
        f"first 5 {first5:.3f}, last 5 {last5:.3f}; every leaf moved and is "
        f"float32; {DETERMINISM_STEPS} steps twice from one state bit-equal; "
        f"params_sha256={digest(tree_leaves(state.params))}")


def run_tool(args: list, timeout: int = 300) -> str:
    """stdout of ``python -m <args>`` run from the repository root; fails
    the smoke run if it exits non-zero."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        fail(f"python -m {' '.join(args)} exited {proc.returncode}")
    return proc.stdout


def run_cli(args: list) -> str:
    """stdout of ``python -m <args>``'s entry point, ``main(argv)``, called
    in this process (which has paid the interpreter's, torch's and the
    card's start once); an exception or exit in it fails the smoke run."""
    module = importlib.import_module(args[0])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            module.main(args[1:])
    except SystemExit as e:
        sys.stderr.write(out.getvalue()[-4000:])
        fail(f"python -m {' '.join(args)} exited {e.code}")
    return out.getvalue()


def check_tools(card_line: str) -> None:
    """Phase 8, the tools: the headless demo and the embeddings export,
    through their entry points in this process."""
    t = time.perf_counter()
    out = run_cli(["air_tpu_torch.demo", "--headless", str(HEADLESS_FRAMES),
                    "--model-path", CKPT])
    recs = [json.loads(line) for line in out.splitlines()]
    keys = {"frame", "digits", "boxes", "nll", "latency_ms"}
    if (len(recs) != HEADLESS_FRAMES
            or any(set(r) != keys or len(r["boxes"]) != r["digits"]
                   or not np.isfinite(r["nll"]) for r in recs)
            or [r["frame"] for r in recs] != list(range(HEADLESS_FRAMES))):
        fail(f"headless demo: {len(recs)} lines, not {HEADLESS_FRAMES} in "
             f"headless_demo.stream's format")
    say("layouts", card_line, f"python -m air_tpu_torch.demo --headless "
        f"{HEADLESS_FRAMES}: {len(recs)} JSON lines, digits "
        f"{[r['digits'] for r in recs]}, median latency "
        f"{float(np.median([r['latency_ms'] for r in recs])):.3f} ms/frame, "
        f"{time.perf_counter() - t:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        pool, labels = load_digit_pool()
        generate_dataset(pool, labels, MultiMNISTConfig(
            images_per_digit=40, test_set_size=60, seed=11),
            out_dir=os.path.join(tmp, "data"))
        folder = os.path.join(tmp, "embeddings")
        out = run_cli(["air_tpu_torch.embeddings", "--model-path", CKPT,
                        "--test-data", os.path.join(tmp, "data",
                                                    "test.airrec"),
                        "--results-folder", folder])
        files = sorted(os.listdir(folder))
        want = ["air_mnist_tensors.tsv", "mnist_metadata.tsv",
                "mnist_sprites.png", "projector_config.pbtxt"]
        if files != want:
            fail(f"embeddings: wrote {files}, not {want}")
        sprite = read_png_grey(os.path.join(folder, "mnist_sprites.png"))
        vectors = np.loadtxt(os.path.join(folder, "air_mnist_tensors.tsv"),
                             delimiter="\t", ndmin=2)
        side = int(np.ceil(np.sqrt(len(vectors)))) * WS
        if sprite.shape != (side, side) or vectors.shape[1] != 50:
            fail(f"embeddings: sprite {sprite.shape}, vectors "
                 f"{vectors.shape}")
        stats = [line for line in out.splitlines() if ":" in line][-4:]
        say("layouts", card_line, f"python -m air_tpu_torch.embeddings over "
            f"60 test canvases generated from the digit pool: {files}; "
            f"{len(vectors)} latents, sprite {sprite.shape} decoded; "
            + "; ".join(stats) + f"; {time.perf_counter() - t:.1f} s")


def check_seed_gradients(config, state0, images, digits, perms,
                         card_line: str) -> None:
    """Step 0 of the seed-parallel step through the path's kernels against
    the plain path (st_impl="xla") at the same params and draws: each
    replica's loss to GRAD_TOL relative, each replica's slice of every
    gradient leaf to GRAD_TOL * max(1, max |slice|)."""
    impl, steps = config.st_impl, config.max_steps
    batch_images, batch_digits = replica_batch(images, digits, perms, 0,
                                               BATCH)
    noise = replica_noise(config, BATCH, state0.seed, state0.step, DEVICE)
    got = {}
    for name in (impl, "xla"):
        before = launches()
        got[name] = replica_gradients(config.replace(st_impl=name), state0,
                                      batch_images, batch_digits,
                                      noise=noise)
        torch.cuda.synchronize()
        expect_launches(before,
                        want_kernels(impl, steps) if name == impl else {},
                        f"seed-parallel step 0 ({name}, "
                        f"S={len(state0.seed)})")
    (g_k, m_k, _), (g_p, m_p, _) = got[impl], got["xla"]
    rel = float(((m_k["loss"] - m_p["loss"]).abs()
                 / m_p["loss"].abs()).max())
    grad_err = 0.0
    for (path, g), w in zip(tree_leaves_with_path(g_k), tree_leaves(g_p)):
        for r in range(len(state0.seed)):
            e = (float((g[r] - w[r]).abs().max())
                 / max(1.0, float(w[r].abs().max())))
            grad_err = max(grad_err, e)
            if not (e <= GRAD_TOL):
                fail(f"seed-parallel {impl} step 0 gradient of replica {r}, "
                     f"{'/'.join(map(str, path))}: kernels vs plain path "
                     f"{e} > {GRAD_TOL} x max(1, max |leaf|)")
    if not rel <= GRAD_TOL:
        fail(f"seed-parallel {impl} step 0 losses, kernels vs plain path: "
             f"relative diff {rel} > {GRAD_TOL}")
    say("seeds", card_line, f"st_impl={impl} S={len(state0.seed)} step 0 "
        f"kernels vs plain path: losses {m_k['loss'].tolist()} (max rel "
        f"{rel:.3g}), gradient leaves max |diff| / max(1, max |leaf|) "
        f"{grad_err:.3g} (tol {GRAD_TOL}); launches "
        f"{want_kernels(impl, steps)} for all the replicas")


def want_kernels(impl: str, steps: int) -> dict:
    """Each of the path's kernels, max_steps launches (one train step)."""
    return {k: steps for k in PATHS[impl][0] + PATHS[impl][1]}


def param_diffs(a_tree, b_tree) -> tuple:
    """(max |diff|, mean |diff| over every element) of two param trees."""
    diffs = [(a - b).abs().reshape(-1)
             for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree))]
    return (max(float(d.max()) for d in diffs),
            float(torch.cat(diffs).mean()))


def apart_ok(worst: float, mean: float, lr: float, steps: int) -> bool:
    """``param_diffs`` of two param trees trained ``steps`` Adam steps with
    bfloat16 moments from the same state, within 2 * steps * lr (and 1e-6
    for the params' own rounding) and a mean within steps * lr * 2**-7.
    Adam moves an element by about lr whatever its gradient's size: a
    gradient element that rounding moves across zero gives steps up to 2 *
    lr apart, and a stored moment that rounds to the other bfloat16
    neighbour (2**-8 relative) an update up to 2**-7 * lr apart."""
    return worst <= 2 * steps * lr + 1e-6 and mean <= steps * lr * 2 ** -7


def params_apart(a_tree, b_tree, lr: float, steps: int) -> tuple:
    """``param_diffs``; fails unless ``apart_ok``."""
    worst, mean = param_diffs(a_tree, b_tree)
    if not apart_ok(worst, mean, lr, steps):
        fail(f"params apart by {worst} (bound {2 * steps * lr}), mean "
             f"{mean} (bound {steps * lr * 2 ** -7})")
    return worst, mean


def step_times(config, n_rep: int, images, digits, captured: bool,
               runs: int = 10) -> dict:
    """Times of one train step on phase 5's batch: the seed-parallel step
    at S = n_rep, the single-seed step at n_rep = 0; captured (one CUDA
    graph replayed per step) or eager. ``ms``: per step from CUDA events
    over ``runs`` steps; ``first_ms``: the first call (host clock, ending
    in a synchronize: with the capture when captured); and
    ``profiled_window``'s counts per step over 3 steps: ``kernels``,
    ``busy_ms``, ``window_ms``, ``summed_ms``."""
    if n_rep:
        states = [create_multi_seed_state(config, range(n_rep),
                                          device=DEVICE)]
        perms = multi_seed_perms(images.shape[0], range(n_rep), 0,
                                 device=DEVICE)
        if captured:
            multi = make_multi_seed_step(config, 1, BATCH)

            def step():
                states[0] = multi(states[0], images, digits, perms, 0)[0]
        else:
            eager = make_replica_step(config)
            batch = replica_batch(images, digits, perms, 0, BATCH)

            def step():
                states[0] = eager(states[0], *batch)[0]
    else:
        states = [create_train_state(config, seed=0, device=DEVICE)]
        single = (make_multi_step(config, 1, BATCH).step if captured
                  else make_train_step(config))

        def step():
            states[0] = single(states[0], images[:BATCH], digits[:BATCH])[0]
    timer = StepTimer(warmup=1)
    with timer.step():
        step()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        step()
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / runs,
            "first_ms": timer.summary()["first_step_ms"],
            **profiled_window(step)}


def st_kernels_per_step(fn, calls: int = 3) -> dict:
    """How many times each of kernels 1-4 ran per call of ``fn``, by the
    names torch.profiler gives the card's kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [name for _, _, name in device_spans(prof)]
    return {k: sum(symbol + "<" in n for n in names) / calls
            for k, symbol in INLINE_SYMBOLS.items()}


def captured_run(config, state0, images, digits, steps: int) -> tuple:
    """``steps`` captured steps on phase 5's batch (perm 0..63, every step
    clamped to the one batch): a first call of one step (the capture) and
    one of the rest. Returns (state, losses, z_pres prior log-odds, first
    call ms)."""
    multi = make_multi_step(config, steps, BATCH)
    perm = torch.arange(BATCH, device=DEVICE)
    timer = StepTimer(warmup=1)
    with timer.step():
        state, m1 = multi(state0, images, digits, perm, 0, num_steps=1)
        torch.cuda.synchronize()
    state, m2 = multi(state, images, digits, perm, 1,
                      num_steps=steps - 1)
    return (state, torch.cat([m1["loss"], m2["loss"]]).tolist(),
            torch.cat([m1["z_pres_prior_log_odds"],
                       m2["z_pres_prior_log_odds"]]).tolist(),
            timer.summary()["first_step_ms"])


def check_captured(train_cfg, state0, images, digits, eager_runs: dict,
                   seeds_run: tuple, card_line: str) -> tuple:
    """Phase 10. Returns the launches of each path's kernels over its
    TRAIN_STEPS captured steps, and the captured single-seed step's
    ms/step."""
    captured_launches, single_ms = {}, None
    for impl in (*PATHS, "xla"):
        config = train_cfg.replace(st_impl=impl)
        if impl not in eager_runs:       # phase 5 trains only the paths
            state, losses = state0, []
            step = make_train_step(config)
            for _ in range(TRAIN_STEPS):
                state, m = step(state, images, digits)
                losses.append(float(m["loss"]))
            eager_runs[impl] = (losses, digest(tree_leaves(state.params)))
        want = {k: TRAIN_STEPS * v for k, v in
                want_kernels(impl, config.max_steps).items()} \
            if impl in PATHS else {}
        reset_launches()
        state, losses, _, first_ms = captured_run(config, state0, images,
                                                  digits, TRAIN_STEPS)
        torch.cuda.synchronize()
        expect_launches({k: 0 for k in launches()}, want,
                        f"{TRAIN_STEPS} captured {impl} steps")
        captured_launches.update(want)
        got = (losses, digest(tree_leaves(state.params)))
        if got != eager_runs[impl]:
            fail(f"{impl}: {TRAIN_STEPS} captured steps part from the eager "
                 f"ones: losses {losses} vs {eager_runs[impl][0]}, params "
                 f"{got[1]} vs {eager_runs[impl][1]}")
        say("captured", card_line, f"st_impl={impl} {TRAIN_STEPS} captured "
            f"steps from create_train_state(seed 0): losses and "
            f"params_sha256={got[1]} bit-equal to the eager run; launches "
            f"{want}; first call (two warm-up steps, the capture, one "
            f"replay) {first_ms:.1f} ms")

    # the training CLI's schedules across the end of the z_pres prior's hold
    args = training.build_parser().parse_args(["--device", DEVICE])
    config, _ = training.configs(args)
    hold = config.schedules["z_pres_prior_log_odds"]["hold"]
    start = hold - HOLD_STEPS // 2
    state = create_train_state(config, seed=0, device=DEVICE)
    state = state.replace(step=start, opt_state=state.opt_state._replace(
        count=start))
    eager, losses, odds_e = make_train_step(config), [], []
    st = state
    for _ in range(HOLD_STEPS):
        st, m = eager(st, images, digits)
        losses.append(float(m["loss"]))
        odds_e.append(float(m["z_pres_prior_log_odds"]))
    reset_launches()
    cap, cap_losses, odds, _ = captured_run(config, state, images, digits,
                                            HOLD_STEPS)
    torch.cuda.synchronize()
    expect_launches({k: 0 for k in launches()},
                    {k: HOLD_STEPS * v for k, v in
                     want_kernels(config.st_impl, config.max_steps).items()},
                    f"{HOLD_STEPS} captured steps across the hold")
    still = HOLD_STEPS // 2 + 1          # steps start .. hold
    moved = all(a != b for a, b in zip(odds[still - 1:], odds[still:]))
    if ((cap_losses, odds, digest(tree_leaves(cap.params)))
            != (losses, odds_e, digest(tree_leaves(st.params)))
            or len(set(odds[:still])) != 1 or not moved):
        fail(f"steps {start}-{start + HOLD_STEPS - 1} across the hold of "
             f"{hold}: captured losses {cap_losses} vs eager {losses}, "
             f"prior log-odds {odds} vs {odds_e}")
    say("captured", card_line, f"--anneal-hold {hold} (the schedules of "
        f"python -m air_tpu_torch.training): {HOLD_STEPS} captured steps "
        f"from step {start} bit-equal to the eager ones (losses, "
        f"params_sha256="
        f"{digest(tree_leaves(cap.params))}); z_pres prior log-odds "
        f"{odds[0]!r} through step {hold}, then "
        + ", ".join(repr(v) for v in odds[still:]))

    # the profiler's names for the kernels of a replayed step
    config = train_cfg.replace(st_impl="inline")
    one = make_multi_step(config, 1, BATCH)
    holder = [state0]

    def replay():
        holder[0] = one.step(holder[0], images, digits)[0]

    per_step = st_kernels_per_step(replay)
    if set(per_step.values()) != {config.max_steps}:
        fail(f"kernels 1-4 per replayed step by the profiler's names: "
             f"{per_step}")
    say("captured", card_line, "torch.profiler over 3 replayed steps: "
        + ", ".join(f"{INLINE_SYMBOLS[k]} {v:.0f}"
                    for k, v in per_step.items()) + " per step")

    # the seed-parallel step: eager against phase 9's captured main run
    perms = multi_seed_perms(BATCH, SEEDS, 0, device=DEVICE)
    st = create_multi_seed_state(config, SEEDS, device=DEVICE)
    eager, losses = make_replica_step(config), []
    for i in range(SEEDS_STEPS):
        st, m = eager(st, *replica_batch(images, digits, perms, i, BATCH))
        losses.append(m["loss"].cpu())
    losses = torch.stack(losses).numpy()
    if not (np.array_equal(losses.view(np.int32),
                           seeds_run[0].view(np.int32))
            and digest(tree_leaves(st.params)) == seeds_run[1]):
        fail(f"seed-parallel: {SEEDS_STEPS} eager steps part from phase 9's "
             f"captured run (params {digest(tree_leaves(st.params))} vs "
             f"{seeds_run[1]})")
    say("captured", card_line, f"S={len(SEEDS)} {SEEDS_STEPS} eager "
        f"seed-parallel steps bit-equal to phase 9's captured run (losses, "
        f"params_sha256={seeds_run[1]})")

    # times on phase 5's batch, captured and eager
    for n_s in (0, *SEED_TIMED):
        s_eff = max(n_s, 1)
        for captured in (True, False):
            t = step_times(config, n_s, images, digits, captured)
            if n_s == 0 and captured:
                single_ms = t["ms"]
            say("captured", card_line, (f"seed-parallel step S={n_s}"
                                        if n_s else "single-seed step")
                + f" ({'captured' if captured else 'eager'}, inline, batch "
                f"{BATCH} per replica): {t['ms']:.3f} ms/step (CUDA events, "
                f"10 steps), {s_eff * BATCH / t['ms'] * 1e3:.1f} images/s; "
                + busy_line(t) + f"; first call {t['first_ms']:.1f} ms")
    return captured_launches, single_ms


def reserved_by(fn) -> tuple:
    """(fn's result, ms of the call on the host clock ending in a
    synchronize, MiB of memory_reserved it added): the memory a first
    call's capture takes, the allocator emptied first."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t) * 1e3,
            (torch.cuda.memory_reserved() - before) / 2 ** 20)


def unrolled_times(call) -> dict:
    """ms/step of ``call(k)`` (k steps) over a call of UNROLL_TIMED steps
    (CUDA events), and the host's ms/step until the call returns."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    call(UNROLL_TIMED)
    host = (time.perf_counter() - t) * 1e3 / UNROLL_TIMED
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / UNROLL_TIMED, "host_ms": host}


def check_unrolled(train_cfg, state0, images, digits, eager_run: tuple,
                   seeds_run: tuple, card_line: str) -> dict:
    """Phase 12 (a). Returns the launches of the 60 steps at each U."""
    config = train_cfg.replace(st_impl="inline")
    perm = torch.arange(BATCH, device=DEVICE)
    per_step = want_kernels("inline", config.max_steps)
    main_launches = {k: 0 for k in per_step}
    for u in UNROLLS:
        multi = make_multi_step(config, TRAIN_STEPS, BATCH,
                                pipeline_unroll=u)
        reset_launches()
        (state, m1), first_ms, pool_mib = reserved_by(
            lambda: multi(state0, images, digits, perm, 0, num_steps=u))
        state, m2 = multi(state, images, digits, perm, u,
                          num_steps=TRAIN_STEPS - u)
        torch.cuda.synchronize()
        expect_launches({k: 0 for k in launches()},
                        {k: TRAIN_STEPS * v for k, v in per_step.items()},
                        f"{TRAIN_STEPS} steps at pipeline_unroll={u}")
        for k in main_launches:
            main_launches[k] += TRAIN_STEPS * per_step[k]
        got = (torch.cat([m1["loss"], m2["loss"]]).tolist(),
               digest(tree_leaves(state.params)))
        if got != eager_run:
            fail(f"pipeline_unroll={u}: {TRAIN_STEPS} steps part from "
                 f"phase 10's (params {got[1]} vs {eager_run[1]})")
        holder = [state]

        def call(k):
            holder[0] = multi(holder[0], images, digits, perm, 0,
                              num_steps=k)[0]

        t = unrolled_times(call)
        say("unrolled", card_line, f"pipeline_unroll={u} single-seed "
            f"(inline, batch {BATCH}): {TRAIN_STEPS} steps, losses and "
            f"params_sha256={got[1]} bit-equal to phase 10's; "
            f"{t['ms']:.3f} ms/step (CUDA events, a call of {UNROLL_TIMED} "
            f"steps; the host returns after {t['host_ms']:.3f} ms/step), "
            f"{BATCH / t['ms'] * 1e3:.1f} images/s; first call ({u} steps, "
            f"the capture) {first_ms:.1f} ms, memory reserved by it "
            f"{pool_mib:+.1f} MiB")
        del multi, holder, state, call

    # the seed-parallel step at S = len(SEEDS), U = SEED_UNROLL, on phase
    # 9's replicas and perms
    u = SEED_UNROLL
    multi = make_multi_seed_step(config, SEEDS_STEPS, BATCH,
                                 pipeline_unroll=u)
    perms = multi_seed_perms(BATCH, SEEDS, 0, device=DEVICE)
    state_s = create_multi_seed_state(config, SEEDS, device=DEVICE)
    (state, m1), first_ms, pool_mib = reserved_by(
        lambda: multi(state_s, images, digits, perms, 0, num_steps=u))
    state, m2 = multi(state, images, digits, perms, u,
                      num_steps=SEEDS_STEPS - u)
    losses = torch.cat([m1["loss"], m2["loss"]]).cpu().numpy()
    got = digest(tree_leaves(state.params))
    if not (np.array_equal(losses.view(np.int32),
                           seeds_run[0].view(np.int32))
            and got == seeds_run[1]):
        fail(f"S={len(SEEDS)} pipeline_unroll={u}: {SEEDS_STEPS} steps part "
             f"from phase 9's (params {got} vs {seeds_run[1]})")
    holder = [state]

    def call(k):
        holder[0] = multi(holder[0], images, digits, perms, 0,
                          num_steps=k)[0]

    t = unrolled_times(call)
    n_img = len(SEEDS) * BATCH
    say("unrolled", card_line, f"pipeline_unroll={u} seed-parallel "
        f"S={len(SEEDS)}: {SEEDS_STEPS} steps, losses and params_sha256="
        f"{got} bit-equal to phase 9's; {t['ms']:.3f} ms/step (CUDA events, "
        f"a call of {UNROLL_TIMED} steps; the host returns after "
        f"{t['host_ms']:.3f} ms/step), {n_img / t['ms'] * 1e3:.1f} images/s; "
        f"first call ({u} steps, the capture) {first_ms:.1f} ms, memory "
        f"reserved by it {pool_mib:+.1f} MiB")
    return main_launches


@contextlib.contextmanager
def unimportable(*names: str):
    """Inside, an import of any of ``names`` fails, as on a machine
    without them."""
    saved = {name: sys.modules.get(name) for name in names}
    sys.modules.update(dict.fromkeys(names))
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                del sys.modules[name]
            else:
                sys.modules[name] = module


def eval_cli(argv: list) -> dict:
    """``python -m air_tpu_torch.eval_checkpoint``'s entry point on the
    card, in this process (its launches counted); its JSON result."""
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        result = eval_checkpoint.main([*argv, "--device", DEVICE])
    torch.cuda.synchronize()
    return result


def check_real_handwriting(card_line: str) -> dict:
    """Phase 12 (b). Returns the launches of the trainer's main run."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "real")
        t = time.perf_counter()
        out = io.StringIO()
        with unimportable("sklearn", "PIL"), contextlib.redirect_stdout(out):
            generate_multi_mnist.main([
                "--source", "sklearn", "--digit-slice", REAL_SLICE,
                "--images-per-digit", str(REAL_PER_STRATUM),
                "--test-set-size", str(REAL_TEST), "--bg-path", REAL_BG,
                "--out-folder", data])
        say("real", card_line, "python -m air_tpu_torch.generate_multi_mnist "
            f"--source sklearn --digit-slice {REAL_SLICE} --images-per-digit "
            f"{REAL_PER_STRATUM} --test-set-size {REAL_TEST} --bg-path "
            f"{os.path.relpath(REAL_BG, REPO)} (scikit-learn and PIL "
            f"unimportable) in {time.perf_counter() - t:.1f} s: "
            + "; ".join(out.getvalue().strip().splitlines()[-3:]))
        log = os.path.join(tmp, "real.log")
        try:
            main_launches, trainer = trainer_and_resume(
                "real", data, ["--pipeline-unroll", str(SEED_UNROLL)], tmp,
                log, card_line)
        except BaseException:
            show_log(log)
            raise

        # the eval CLI: the trained checkpoint on the held-out set, the
        # shipped one on the fixture
        fixture = os.path.join(tmp, "fixture", "test.airrec")
        with np.load(FIXTURE) as z:
            write_records(fixture, z["canvases"], z["digits"])
        fwd = PATHS["inline"][0]
        results = []
        for model, test in ((trainer.models_dir,
                             os.path.join(data, "test.airrec")),
                            (CKPT, fixture)):
            reset_launches()
            result = eval_cli(["--model-path", model, "--test-data", test])
            expect_launches({k: 0 for k in launches()},
                            {k: trainer.config.max_steps for k in fwd},
                            f"eval_checkpoint of {os.path.basename(model)}")
            results.append(result)
        if not results[1]["accuracy"] >= MIN_ACCURACY:
            fail(f"eval_checkpoint: the shipped checkpoint scores "
                 f"{results[1]['accuracy']} on the fixture, below "
                 f"{MIN_ACCURACY}")
        for what, r in zip(("the trained checkpoint on its held-out set",
                            "the shipped checkpoint on the fixture"),
                           results):
            say("real", card_line, f"python -m air_tpu_torch.eval_checkpoint "
                f"({what}, kernels 1-2 {trainer.config.max_steps} times "
                f"each): " + json.dumps({k: v for k, v in r.items()
                                         if k != "checkpoint"}))
    return main_launches


def generic_ptxas(report: str) -> list:
    """(kernel, its ptxas lines) of each run-time-size instantiation
    (template arguments <0, 0, ...>) in a library's -Xptxas -v report."""
    out, name = [], None
    for line in report.splitlines():
        if "entry function" in line:
            found = re.search(r"(st_[a-z_]*kernel)I((?:Li\d+E)+)E", line)
            args = found and re.findall(r"Li(\d+)E", found.group(2))
            name = (found and args[:2] == ["0", "0"]
                    and f"{found.group(1)}<{', '.join(args)}>")
            if name:
                out.append((name, []))
        elif name and ("registers" in line or "smem" in line
                       or "spill" in line):
            out[-1][1].append(line.split(":", 1)[-1].strip())
    return out


def dynamic_smem(b: int, cs: int, ws: int) -> dict:
    """Each kernel's dynamic shared memory per block, in bytes, at batch b,
    canvas cs and window ws, from its wrapper's launch geometry (above
    48 KB the launchers set cudaFuncAttributeMaxDynamicSharedMemorySize)."""
    return {
        "inline_attention_read":
            st_inline.fwd_geometry(b, cs, ws, "read").smem_bytes,
        "inline_write_accumulate":
            st_inline.fwd_geometry(b, ws, cs, "write").smem_bytes,
        "inline_attention_read_bwd":
            st_inline.read_bwd_geometry(b, cs, ws).smem_bytes,
        "inline_write_accumulate_bwd":
            st_inline.write_bwd_geometry(cs, ws).smem_bytes,
        "pallas_attention_read":
            st_pallas.geometry(b, ws, ws, cs, cs).smem_bytes,
        "pallas_attention_write":
            st_pallas.geometry(b, cs, cs, ws, ws).smem_bytes,
        "fused_write_accumulate": st_fused.geometry(b, cs, ws).smem_bytes,
        "fused_write_accumulate_bwd":
            st_fused.bwd_geometry(b, cs, ws).smem_bytes}


def check_scaled_kernels(libs: dict, card_line: str) -> dict:
    """Phase 13 (a): every kernel at canvas SCALED_CS, window WS against its
    plain version at each of SCALED_KERNEL_BATCHES with the window scalars
    of each of SCALAR_RANGES (and at canvas CS with the ranges phase 3 does
    not draw); at B = SCALED_BATCH its ms per launch beside its bound, its
    plain version and its library chain; the ptxas report of the
    run-time-size instantiations. Returns {kernel: kernel_times}."""
    for i, scalar_range in enumerate(SCALAR_RANGES):
        kernel_errors(SCALED_KERNEL_BATCHES, SCALED_CS, WS, 5000 + 10 * i,
                      "configs", card_line, scalar_range)
        if scalar_range != "smoke":      # phase 3 ran the smoke range
            kernel_errors((SCALED_BATCH, 7), CS, WS, 5500 + 10 * i,
                          "configs", card_line, scalar_range)
    sets = input_sets(SCALED_BATCH, 6000, 6001, SCALED_CS, WS)
    out = {}
    for kname in SWEPT:
        out[kname] = kernel_times(kname, sets)
        say("configs", card_line, f"{kname} B={SCALED_BATCH} at "
            f"({SCALED_CS}, {WS}): " + times_line(out[kname]))
    for lib_name, built in libs.items():
        for name, lines in generic_ptxas(built.ptxas_report):
            say("configs", card_line, f"ptxas {lib_name} {name}: "
                + " | ".join(lines))
    say("configs", card_line, f"dynamic shared memory per block at B="
        f"{SCALED_BATCH}, ({SCALED_CS}, {WS}), bytes: " + " ".join(
            f"{k}={v}" for k, v in dynamic_smem(SCALED_BATCH, SCALED_CS,
                                                WS).items()))
    return out


def scaled_batch() -> tuple:
    """SCALED_BATCH canvases of 0-2 digits at canvas SCALED_CS generated from
    the committed digit pool, and their digit counts, on the card."""
    pool, labels = load_digit_pool()
    per = -(-(SCALED_BATCH + 3) // 3)
    got = generate_dataset(pool, labels, MultiMNISTConfig(
        canvas_size=SCALED_CS, images_per_digit=per,
        test_set_size=3 * per - SCALED_BATCH, seed=0))
    images = np.stack(got["common"]["images"]).reshape(SCALED_BATCH, -1)
    return (torch.from_numpy(images.astype(np.float32)).to(DEVICE),
            torch.as_tensor(got["common"]["digits"], dtype=torch.int32,
                            device=DEVICE))


def check_scaled_train(card_line: str) -> tuple:
    """Phase 13 (b): the scaled configuration's train step at batch
    SCALED_BATCH. Returns (the inline kernels' launches in the captured
    run, the config, the trained params, the batch's canvases)."""
    args = training.build_parser().parse_args(["--device", DEVICE,
                                               *SCALED_FLAGS])
    config, _ = training.configs(args)
    t = time.perf_counter()
    images, digits = scaled_batch()
    say("configs", card_line, f"scaled: {SCALED_BATCH} canvases of "
        f"{SCALED_CS}x{SCALED_CS} generated from the committed pool in "
        f"{time.perf_counter() - t:.1f} s; config canvas "
        f"{config.canvas_size}, LSTM {config.rnn_units}, latent "
        f"{config.vae_latent_dimensions}, {config.max_steps} steps, "
        f"st_impl={config.st_impl}")
    state0 = create_train_state(config, seed=0, device=DEVICE)
    noise = draw_noise(config, SCALED_BATCH, step_generator(0, 0, DEVICE),
                       DEVICE)
    m = {}
    for impl in ("xla", "inline", "pallas"):
        step = make_train_step(config.replace(st_impl=impl),
                               with_grad_stats=True)
        before = launches()
        _, m[impl] = step(state0, images, digits, noise=noise)
        torch.cuda.synchronize()
        expect_launches(before, want_kernels(impl, config.max_steps)
                        if impl in PATHS else {}, f"scaled step 0 ({impl})")
        del step
        if impl in PATHS:
            say("configs", card_line, f"scaled step 0 through the {impl} "
                f"kernels vs plain path: "
                + against_plain(impl, m[impl], m["xla"]))
    del m

    per_step = want_kernels("inline", config.max_steps)
    train_step = make_train_step(config)
    state, losses, recons = state0, [], []
    reset_launches()
    for _ in range(SCALED_STEPS):
        state, metrics = train_step(state, images, digits)
        losses.append(float(metrics["loss"]))
        recons.append(float(metrics["reconstruction_loss"]))
    expect_launches({k: 0 for k in launches()},
                    {k: SCALED_STEPS * v for k, v in per_step.items()},
                    f"{SCALED_STEPS} eager scaled steps")
    eager = (losses, digest(tree_leaves(state.params)))
    del state, train_step

    multi = make_multi_step(config, SCALED_STEPS, SCALED_BATCH)
    perm = torch.arange(SCALED_BATCH, device=DEVICE)
    reset_launches()
    (state, m1), first_ms, pool_mib = reserved_by(
        lambda: multi(state0, images, digits, perm, 0, num_steps=1))
    state, m2 = multi(state, images, digits, perm, 1,
                      num_steps=SCALED_STEPS - 1)
    torch.cuda.synchronize()
    main_launches = {k: SCALED_STEPS * v for k, v in per_step.items()}
    expect_launches({k: 0 for k in launches()}, main_launches,
                    f"{SCALED_STEPS} captured scaled steps")
    captured = (torch.cat([m1["loss"], m2["loss"]]).tolist(),
                digest(tree_leaves(state.params)))
    if captured != eager:
        fail(f"scaled: {SCALED_STEPS} captured steps part from the eager "
             f"ones (params {captured[1]} vs {eager[1]})")
    first = float(np.mean(recons[:SCALED_MEAN_OF]))
    last = float(np.mean(recons[-SCALED_MEAN_OF:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        fail(f"scaled: mean reconstruction loss of the last {SCALED_MEAN_OF} "
             f"steps {last} not below that of the first {SCALED_MEAN_OF} "
             f"{first}, or a loss is not finite")
    params = tree_unflatten(state.params,
                            [t.clone() for t in tree_leaves(state.params)])
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, state)
        test = os.path.join(tmp, "scaled.airrec")
        write_records(test, images.cpu().numpy(), digits.cpu().numpy())
        reset_launches()
        result = eval_cli(["--model-path", path, "--test-data", test,
                           "--batch-size", str(SCALED_BATCH),
                           *SCALED_FLAGS[:6]])
    expect_launches({k: 0 for k in launches()},
                    {k: config.max_steps for k in PATHS["inline"][0]},
                    "eval_checkpoint of the scaled step's checkpoint")
    say("configs", card_line, "scaled: python -m air_tpu_torch."
        f"eval_checkpoint {' '.join(SCALED_FLAGS[:6])} on the "
        f"{SCALED_BATCH} canvases (kernels 1-2 {config.max_steps} times "
        "each): " + json.dumps({k: v for k, v in result.items()
                                if k != "checkpoint"}))
    holder = [state]

    def step():
        holder[0] = multi(holder[0], images, digits, perm, 0,
                          num_steps=1)[0]

    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        step()
    end.record()
    torch.cuda.synchronize()
    timed = {"ms": start.elapsed_time(end) / 10, **profiled_window(step)}
    say("configs", card_line, f"scaled: {SCALED_STEPS} captured steps "
        f"(batch {SCALED_BATCH}) bit-equal to {SCALED_STEPS} eager ones "
        f"(losses, params_sha256={captured[1]}); launches={main_launches} "
        f"({config.max_steps} a step each); loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, reconstruction loss mean of first "
        f"{SCALED_MEAN_OF} {first:.3f}, last {SCALED_MEAN_OF} {last:.3f}; "
        f"{timed['ms']:.3f} ms/step (CUDA "
        f"events, 10 steps), {SCALED_BATCH / timed['ms'] * 1e3:.1f} "
        f"images/s; " + busy_line(timed) + f"; first call (the capture) "
        f"{first_ms:.1f} ms, memory reserved by it (slots and the graph's "
        f"pool) {pool_mib:+.1f} MiB")
    del multi, holder, state
    return main_launches, config, params, images.cpu().numpy()


def check_harder(card_line: str) -> tuple:
    """Phase 13 (c): the harder configuration through the generator, the
    trainer (as phase 7 runs it, with HARDER_FLAGS) and the eval CLI.
    Returns (the trainer's main-run launches, its config, its trained
    params, its held-out canvases and digit counts)."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "harder")
        t = time.perf_counter()
        out = io.StringIO()
        argv = [*HARDER_DATA, "--images-per-digit", str(HARDER_PER_STRATUM),
                "--test-set-size", str(HARDER_TEST), "--out-folder", data]
        with contextlib.redirect_stdout(out):
            generate_multi_mnist.main(argv)
        say("configs", card_line, "harder: python -m air_tpu_torch."
            f"generate_multi_mnist {' '.join(argv[:-2])} in "
            f"{time.perf_counter() - t:.1f} s: "
            + "; ".join(out.getvalue().strip().splitlines()[-2:]))
        log = os.path.join(tmp, "harder.log")
        try:
            main_launches, trainer = trainer_and_resume(
                "configs", data, HARDER_FLAGS, tmp, log, card_line)
        except BaseException:
            show_log(log)
            raise
        test = os.path.join(data, "test.airrec")
        reset_launches()
        result = eval_cli(["--model-path", trainer.models_dir, "--test-data",
                           test, "--max-steps", "5", "--max-digits", "3"])
        expect_launches({k: 0 for k in launches()},
                        {k: trainer.config.max_steps
                         for k in PATHS["inline"][0]},
                        "eval_checkpoint of the harder run")
        say("configs", card_line, "harder: python -m air_tpu_torch."
            "eval_checkpoint --max-steps 5 --max-digits 3 on its held-out "
            f"set (kernels 1-2 {trainer.config.max_steps} times each): "
            + json.dumps({k: v for k, v in result.items()
                          if k != "checkpoint"}))
        canvases, truth = load_test_data(test)
    return (main_launches, trainer.config, trainer.state.params, canvases,
            truth)


def check_config_serving(name: str, config, params, canvases, sizes,
                         card_line: str) -> None:
    """Phase 13 (d): ModelWrapper.infer at ``config`` on trained ``params``
    (the port's tree): through kernels 1-2 (the scan layout) against the
    plain path, reconstructions to PATH_TOL and digit counts equal; the
    wrapper's default (step-parallel, no kernel) against the same;
    latencies for each of ``sizes`` canvases."""
    jparams = params_to_jax(params)
    kern = ModelWrapper(config.replace(st_impl="inline"), jparams, seed=0,
                        decoder_layout="scan", device=DEVICE)
    plain = ModelWrapper(config.replace(st_impl="xla"), jparams, seed=0,
                         decoder_layout="scan", device=DEVICE)
    default = ModelWrapper(config.replace(st_impl="xla"), jparams, seed=0,
                           device=DEVICE)
    requests = [canvases[np.arange(n) % len(canvases)] for n in sizes]
    fwd = PATHS["inline"][0]
    reset_launches()
    served = []
    for req in requests:
        before = launches()
        served.append(kern.infer(req))
        expect_launches(before, {k: config.max_steps for k in fwd},
                        f"{name}: one infer call of {len(req)} canvases")
    reset_launches()
    defaults = [default.infer(req) for req in requests]
    torch.cuda.synchronize()
    expect_launches({k: 0 for k in launches()}, {},
                    f"{name}: step-parallel serving")
    errs = {"kernels": 0.0, "step-parallel": 0.0}
    for req, got, sp in zip(requests, served, defaults):
        want = plain.infer(req)
        for what, out in (("kernels", got), ("step-parallel", sp)):
            if list(out[0]) != list(want[0]):
                fail(f"{name}: digit counts through the {what} path differ "
                     f"from the plain scan's on {len(req)} canvases")
            if not all(np.all(np.isfinite(r)) for r in out[2]):
                fail(f"{name}: non-finite reconstructions ({what})")
            errs[what] = max(errs[what], max(
                float(np.max(np.abs(a - b))) for a, b in zip(out[2],
                                                             want[2])))
    if not all(e <= PATH_TOL for e in errs.values()):
        fail(f"{name}: reconstructions differ from the plain scan's by "
             f"{errs}")
    lat = {label: {n: infer_latency(w, canvases, n) for n in sizes}
           for label, w in (("kernels", kern), ("step-parallel", default))}
    say("configs", card_line, f"serve {name} (T={config.max_steps}, canvas "
        f"{config.canvas_size}): requests {list(sizes)}, kernels 1-2 "
        f"{config.max_steps} times an infer through the scan layout, 0 at "
        f"the wrapper's default (step-parallel); digit counts equal to the "
        f"plain scan's, reconstructions vs it max abs "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {PATH_TOL}); infer latency median of 10: "
        + "; ".join(f"{label} " + ", ".join(f"{n}: {ms:.3f} ms"
                                            for n, ms in t.items())
                    for label, t in lat.items())
        + f"; reconstructions_sha256="
        f"{digest(r for got in served for r in got[2])}")


def check_configs(libs: dict, card_line: str) -> tuple:
    """Phase 13. Returns (phase (a)'s kernel times, the launches of (b)'s
    captured run and (c)'s trainer run, summed)."""
    times = check_scaled_kernels(libs, card_line)
    scaled_launches, config, params, canvases = check_scaled_train(card_line)
    check_config_serving("scaled", config, params, canvases,
                         (1, BATCH, SCALED_BATCH), card_line)
    del params
    harder_launches, config, params, canvases, _ = check_harder(card_line)
    check_config_serving("harder", config, params, canvases, (1, BATCH),
                         card_line)
    return times, {k: scaled_launches.get(k, 0) + harder_launches.get(k, 0)
                   for k in KERNELS}


def grad_errors(got, want, placements=None, model_rank=0) -> float:
    """The largest |got - want| / max(1, max |want leaf|) over two gradient
    trees (phase 5's measure); a leaf ``placements`` marks sharded is held
    against this model rank's half of ``want``'s."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        if placements is not None and placements[i]:
            w = take_slice(w, 2, model_rank)
        worst = max(worst, float((g - w).abs().max())
                    / max(1.0, float(w.abs().max())))
    return worst


def rank_nccl(rank, device, train_cfg, images, digits) -> dict:
    """Phase 11 (a) in the one rank of an NCCL world: PARALLEL_EAGER eager
    data-parallel steps, TRAIN_STEPS captured ones (phase 10's calls), and
    ms/step (CUDA events, 10 steps) of the captured single-card step and
    of the captured data-parallel one."""
    images, digits = (torch.from_numpy(a).to(device) for a in (images,
                                                                digits))
    mesh = make_mesh()
    state0 = create_train_state(train_cfg, seed=0, device=device)
    step = make_parallel_train_step(train_cfg, mesh)
    reset_launches()
    state, losses = state0, []
    for _ in range(PARALLEL_EAGER):
        state, m = step(state, *shard_batch(mesh, images, digits))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    out = {"eager": (losses, digest(tree_leaves(state.params)), launches())}
    multi = make_parallel_multi_step(train_cfg, TRAIN_STEPS, BATCH, mesh)
    perm = torch.arange(BATCH, device=device)
    reset_launches()
    state, m1 = multi(state0, images, digits, perm, 0, num_steps=1)
    state, m2 = multi(state, images, digits, perm, 1,
                      num_steps=TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    out["captured"] = (torch.cat([m1["loss"], m2["loss"]]).tolist(),
                       digest(tree_leaves(state.params)), launches())
    out["ms"] = {}
    for name, one in (
            ("single-card", make_multi_step(train_cfg, 1, BATCH)),
            ("data-parallel", make_parallel_multi_step(train_cfg, 1, BATCH,
                                                       mesh))):
        holder = [state0]
        for _ in range(3):
            holder[0] = one.step(holder[0], images, digits)[0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            holder[0] = one.step(holder[0], images, digits)[0]
        end.record()
        torch.cuda.synchronize()
        out["ms"][name] = start.elapsed_time(end) / 10
    return out


def single_card_step0(config, state0, images, digits, rows: int) -> dict:
    """The single-card step 0 on the whole batch (its new params and
    gradients) and the mean of its gradients on the batch's halves of
    ``rows`` rows with their rows of the same draws: the data-parallel
    step's arithmetic on one card."""
    device = images.device
    step = make_train_step(config, with_grad_stats=True)
    new, m = step(state0, images, digits)
    noise = draw_noise(config, images.shape[0],
                       step_generator(state0.seed, 0, device), device)
    parts = []
    for lo in range(0, images.shape[0], rows):
        at = slice(lo, lo + rows)
        parts.append(tree_leaves(step(
            state0, images[at], digits[at],
            noise={k: v[:, at] for k, v in noise.items()})[1][
                "grad_tensors"]["original"]))
    grads = m["grad_tensors"]["original"]
    halves = [sum(leaf) / len(parts) for leaf in zip(*parts)]
    return {"params": new.params, "loss": float(m["loss"]), "grads": grads,
            "halves": tree_unflatten(grads, halves)}


def rank_gloo_data(rank, device, train_cfg, images, digits) -> dict:
    """Phase 11 (b) in one rank of a gloo world of two on the card: step 0
    (eager) against the single-card step, then PARALLEL_STEPS captured
    data-parallel steps."""
    images, digits = (torch.from_numpy(a).to(device) for a in (images,
                                                                digits))
    mesh = make_mesh(2)
    state0 = create_train_state(train_cfg, seed=0, device=device)
    reset_launches()
    new, m_p = make_parallel_train_step(train_cfg, mesh,
                                        with_grad_stats=True)(
        state0, *shard_batch(mesh, images, digits))
    torch.cuda.synchronize()
    out = {"step_launches": launches()}
    one = single_card_step0(train_cfg, state0, images, digits,
                            BATCH // mesh.data)
    grads = m_p["grad_tensors"]["original"]
    out.update(loss=(float(m_p["loss"]), one["loss"]),
               grad_err=grad_errors(grads, one["halves"]),
               full_err=grad_errors(grads, one["grads"]),
               order_err=grad_errors(one["halves"], one["grads"]),
               apart=param_diffs(new.params, one["params"]))
    multi = make_parallel_multi_step(train_cfg, PARALLEL_K, BATCH, mesh)
    perm = torch.arange(BATCH, device=device)
    reset_launches()
    state, losses, recons = state0, [], []
    for start in range(0, PARALLEL_STEPS, PARALLEL_K):
        state, m = multi(state, images, digits, perm, start)
        losses += m["loss"].tolist()
        recons += m["reconstruction_loss"].tolist()
    torch.cuda.synchronize()
    out.update(run_launches=launches(), losses=losses, recons=recons,
               params=digest(tree_leaves(state.params)),
               still=[path_name(p) for (p, a), b in zip(
                   tree_leaves_with_path(state.params),
                   tree_leaves(state0.params)) if torch.equal(a, b)])
    return out


def rank_gloo_model(rank, device, train_cfg, images, digits) -> dict:
    """Phase 11 (c) in one rank of a gloo world of four on the card, data 2
    x model 2: the shards' shapes, and step 0 against the single-card step
    with the rnn input hoist off and on."""
    images, digits = (torch.from_numpy(a).to(device) for a in (images,
                                                                digits))
    mesh = make_mesh(4, model_axis=2)
    out = {}
    for hoist in (False, True):
        config = train_cfg.replace(rnn_input_hoist=hoist)
        state0 = create_train_state(config, seed=0, device=device)
        state = shard_state(mesh, state0)
        shapes = {path_name(p): (tuple(t.shape), tuple(m.shape))
                  for (p, t), m in zip(tree_leaves_with_path(state.params),
                                       tree_leaves(state.opt_state.mu))}
        reset_launches()
        new, m_p = make_parallel_train_step(config, mesh,
                                            with_grad_stats=True)(
            state, *shard_batch(mesh, images, digits))
        torch.cuda.synchronize()
        step_launches = launches()
        one = single_card_step0(config, state0, images, digits,
                                BATCH // mesh.data)
        placed = param_sharding(mesh, state0.params)
        grads = m_p["grad_tensors"]["original"]
        norm = float(global_norm(one["halves"]))
        out[hoist] = {
            "shapes": shapes, "step_launches": step_launches,
            "loss": (float(m_p["loss"]), one["loss"]),
            "norm_err": abs(float(m_p["grad_norm"]) - norm) / norm,
            "grad_err": grad_errors(grads, one["halves"], placed,
                                    mesh.model_rank),
            "full_err": grad_errors(grads, one["grads"], placed,
                                    mesh.model_rank),
            "order_err": grad_errors(one["halves"], one["grads"]),
            "apart": param_diffs(gather_state(mesh, new, config).params,
                                 one["params"])}
    return out


def check_parallel(train_cfg, images, digits, eager_runs: dict,
                   single_ms: float, card_line: str) -> dict:
    """Phase 11 on phase 5's batch, through st_impl="inline" (kernels 1-4).
    Returns the launches of kernels 1-4 in (a)'s TRAIN_STEPS captured
    data-parallel steps."""
    train_cfg = train_cfg.replace(st_impl="inline")
    host = (images.cpu().numpy(), digits.cpu().numpy())
    # every rank on the one card, by its index
    card_0 = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    want_step = want_kernels("inline", train_cfg.max_steps)

    def loss_rel(pair) -> float:
        return abs(pair[0] - pair[1]) / abs(pair[1])

    def moved_by(counts: dict, steps: int, what: str) -> None:
        want = {k: steps * want_step.get(k, 0) for k in counts}
        if counts != want:
            fail(f"{what} launched {counts}, expected {want}")

    # (a) NCCL, a world of one
    single = make_train_step(train_cfg)
    state, losses = create_train_state(train_cfg, seed=0, device=DEVICE), []
    for _ in range(PARALLEL_EAGER):
        state, m = single(state, images, digits)
        losses.append(float(m["loss"]))
    a = launch(rank_nccl, "nccl", [card_0], (train_cfg, *host),
               timeout=RANK_SECONDS)[0]
    e_losses, e_params, e_launches = a["eager"]
    moved_by(e_launches, PARALLEL_EAGER, "(a) the eager data-parallel steps")
    if (e_losses, e_params) != (losses, digest(tree_leaves(state.params))):
        fail(f"(a) {PARALLEL_EAGER} eager data-parallel steps over NCCL "
             f"part from the single-card steps: {e_losses} vs {losses}")
    c_losses, c_params, c_launches = a["captured"]
    moved_by(c_launches, TRAIN_STEPS, "(a) the captured data-parallel steps")
    if (c_losses, c_params) != eager_runs["inline"]:
        fail(f"(a) {TRAIN_STEPS} captured data-parallel steps over NCCL "
             f"part from phases 5 and 10: params {c_params} vs "
             f"{eager_runs['inline'][1]}")
    say("parallel", card_line, f"(a) NCCL world of one: {PARALLEL_EAGER} "
        f"eager data-parallel steps bit-equal to the single-card eager "
        f"steps (losses, params_sha256={e_params}); {TRAIN_STEPS} captured "
        f"data-parallel steps bit-equal to phases 5 and 10 (params_sha256="
        f"{c_params}); launches "
        f"{ {k: v for k, v in c_launches.items() if v} }")
    say("parallel", card_line, "(a) captured step ms (CUDA events, 10 "
        "steps, batch 64, in the rank): "
        + ", ".join(f"{k} {v:.3f}" for k, v in a["ms"].items())
        + f"; phase 10's single-seed captured step {single_ms:.3f}")
    check_parallel_trainer(card_line)

    # (b) gloo, two ranks on the card, data axis 2, and (c) gloo, four
    # ranks, data 2 x model 2: both check the algorithm and time nothing,
    # so their ranks run at once
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(launch, fn, "gloo", [card_0] * n,
                            (train_cfg, *host), timeout=RANK_SECONDS)
                for fn, n in ((rank_gloo_data, 2), (rank_gloo_model, 4))]
        b, c = (run.result() for run in runs)
    lr = train_cfg.learning_rate
    for r, out in enumerate(b):
        moved_by(out["step_launches"], 1, f"(b) rank {r}'s step 0")
        moved_by(out["run_launches"], PARALLEL_STEPS,
                 f"(b) rank {r}'s {PARALLEL_STEPS} steps")
        rel = loss_rel(out["loss"])
        if not (rel <= GRAD_TOL and out["grad_err"] <= GRAD_TOL
                and out["full_err"] <= max(GRAD_TOL, out["order_err"])
                and apart_ok(*out["apart"], lr, 1)):
            fail(f"(b) rank {r} step 0 against the single-card step: loss "
                 f"rel {rel}, gradients {out['grad_err']} against its halves "
                 f"(tol {GRAD_TOL}), {out['full_err']} against the whole "
                 f"batch (the card's own halves {out['order_err']}), params "
                 f"apart {out['apart']}")
        first5 = float(np.mean(out["recons"][:5]))
        last5 = float(np.mean(out["recons"][-5:]))
        if (not np.all(np.isfinite(out["losses"])) or out["still"]
                or not last5 < first5):
            fail(f"(b) rank {r}: losses {out['losses']}, leaves that did "
                 f"not move {out['still']}")
    if b[0]["params"] != b[1]["params"]:
        fail(f"(b) the ranks' params part: {[o['params'] for o in b]}")
    say("parallel", card_line, f"(b) gloo, 2 ranks on the card: step 0's "
        f"all-reduced gradients against the single-card step on the ranks' "
        f"halves of the batch {max(o['grad_err'] for o in b):.3g} (tol "
        f"{GRAD_TOL}), on the whole batch {max(o['full_err'] for o in b):.3g}"
        f" (the single card's halves against its whole batch "
        f"{b[0]['order_err']:.3g}), params after the step apart by "
        f"{b[0]['apart'][0]:.3g} (mean {b[0]['apart'][1]:.3g}; bound "
        f"{2 * lr:.3g}), loss {b[0]['loss'][0]:.4f} vs "
        f"{b[0]['loss'][1]:.4f}; "
        f"{PARALLEL_STEPS} captured steps, each rank launching kernels 1-4 "
        f"{train_cfg.max_steps} times a step; reconstruction loss mean of "
        f"first 5 {np.mean(b[0]['recons'][:5]):.3f}, last 5 "
        f"{np.mean(b[0]['recons'][-5:]):.3f}; both ranks params_sha256="
        f"{b[0]['params']} (a correctness check: two processes on one card "
        "time nothing)")

    units = train_cfg.rnn_units
    halves = {"lstm/kernel": 4 * units,
              **{f"vae/rec/{i}/w": n for i, n in enumerate(
                  train_cfg.vae_recognition_units)},
              **{f"vae/gen/{i}/w": n for i, n in enumerate(
                  train_cfg.vae_generative_units)}}
    for r, out in enumerate(c):
        for hoist, res in out.items():
            for name, full in halves.items():
                got, mom = res["shapes"][name]
                if got[1] != full // 2 or mom != got:
                    fail(f"(c) rank {r}: {name} held as {got}, moments "
                         f"{mom}; expected {full // 2} columns")
            moved_by(res["step_launches"], 1, f"(c) rank {r}'s step")
            rel = loss_rel(res["loss"])
            if not (rel <= SEED_LOSS_TOL and apart_ok(*res["apart"], lr, 1)
                    and res["grad_err"] <= MODEL_GRAD_TOL
                    and res["norm_err"] <= MODEL_GRAD_TOL):
                fail(f"(c) rank {r} rnn_input_hoist={hoist}: loss rel {rel}, "
                     f"params after the step apart {res['apart']}, "
                     f"gradients {res['grad_err']} and their norm (rel) "
                     f"{res['norm_err']} against the single card's halves "
                     f"(tol {MODEL_GRAD_TOL})")
    say("parallel", card_line, "(c) gloo, 4 ranks on the card, data 2 x "
        "model 2: the LSTM gate kernel and the VAE hidden kernels ("
        + ", ".join(halves) + ") and their moments held as column halves; "
        "step 0 against the single-card step: "
        + "; ".join(
            f"rnn_input_hoist={h}: loss rel "
            f"{max(loss_rel(o[h]['loss']) for o in c):.3g}"
            f" (tol {SEED_LOSS_TOL}), params after the step apart by "
            f"{max(o[h]['apart'][0] for o in c):.3g} (mean "
            f"{max(o[h]['apart'][1] for o in c):.3g}; bound {2 * lr:.3g}), "
            f"gradients {max(o[h]['grad_err'] for o in c):.3g} and their "
            f"norm (rel) {max(o[h]['norm_err'] for o in c):.3g} against the "
            f"single card's halves (tol {MODEL_GRAD_TOL}), gradients "
            f"{max(o[h]['full_err'] for o in c):.3g} against its whole batch "
            f"(its halves against its whole batch "
            f"{c[0][h]['order_err']:.3g})" for h in (False, True))
        + f"; each rank launching kernels 1-4 {train_cfg.max_steps} times a "
        "step")
    return {k: TRAIN_STEPS * v for k, v in want_step.items()}


def check_parallel_trainer(card_line: str) -> None:
    """Phase 11 (a), the driver: ``python -m air_tpu_torch.training
    --data-parallel --n-devices 1 --device-data`` for
    PARALLEL_TRAINER_STEPS steps, then again from its step-
    PARALLEL_RESUME_AT checkpoint: the same losses from there and the same
    final params, bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        pool, labels = load_digit_pool()
        data = os.path.join(tmp, "data")
        generate_dataset(pool, labels, MultiMNISTConfig(
            images_per_digit=TRAINER_PER_STRATUM, test_set_size=TRAINER_TEST,
            seed=0), out_dir=data)
        every = str(PARALLEL_RESUME_AT)
        cmd = ["air_tpu_torch.training", "--data-parallel", "--n-devices",
               "1", "--device-data", "--train-data",
               os.path.join(data, "common.airrec"), "--test-data",
               os.path.join(data, "test.airrec"), "--steps",
               str(PARALLEL_TRAINER_STEPS), "--multi-step", "10",
               "--eval-every", every, "--save-every", every, "--grad-every",
               every, "--img-every", every, "--log-every", "1"]
        runs = {}
        for name in ("a", "b"):
            folder = os.path.join(tmp, name)
            if name == "b":
                os.makedirs(os.path.join(folder, "models"))
                for ext in (".npz", ".json"):
                    shutil.copy(os.path.join(
                        tmp, "a", "models",
                        f"air-model-{PARALLEL_RESUME_AT}{ext}"),
                        os.path.join(folder, "models"))
            t = time.perf_counter()
            log = run_tool([*cmd, "--results-folder", folder])
            losses = {}
            with open(os.path.join(folder, "summary", "metrics.jsonl")) as f:
                for line in f:
                    rec = json.loads(line)
                    if "train/loss" in rec:
                        losses[rec["step"]] = rec["train/loss"]
            with np.load(os.path.join(
                    folder, "models",
                    f"air-model-{PARALLEL_TRAINER_STEPS}.npz")) as z:
                params = digest([z[k] for k in sorted(z.files)
                                 if k.startswith("params/")])
            runs[name] = (losses, params, time.perf_counter() - t,
                          log.strip().splitlines()[-1])
    (a_losses, a_params, a_s, a_end), (b_losses, b_params, b_s, _) = (
        runs["a"], runs["b"])
    tail = range(PARALLEL_RESUME_AT + 1, PARALLEL_TRAINER_STEPS + 1)
    if (sorted(a_losses) != list(range(1, PARALLEL_TRAINER_STEPS + 1))
            or [b_losses.get(s) for s in tail] != [a_losses[s] for s in tail]
            or a_params != b_params):
        fail("(a) python -m air_tpu_torch.training --data-parallel: the "
             f"run resumed from step {PARALLEL_RESUME_AT} does not repeat "
             "the uninterrupted one (losses or params)")
    say("parallel", card_line, f"(a) python -m air_tpu_torch.training "
        f"--data-parallel --n-devices 1 --device-data: "
        f"{PARALLEL_TRAINER_STEPS} steps in {a_s:.1f} s ({a_end}); resumed "
        f"from step {PARALLEL_RESUME_AT} in {b_s:.1f} s: losses of steps "
        f"{PARALLEL_RESUME_AT + 1}-{PARALLEL_TRAINER_STEPS} and the final "
        f"params_sha256={a_params} bit-equal")


def check_seeds(train_cfg, images, digits, card_line: str) -> tuple:
    """Phase 9 on phase 5's batch (``images``, ``digits``: 64 canvases,
    each replica in its own order). Returns the kernels' launches in its
    main run (kernels 1-4: the SEEDS_STEPS seed-parallel steps) and in the
    seed-parallel pallas steps (kernels 5-7), and the main run's [steps, S]
    losses and params digest."""
    config = train_cfg.replace(st_impl="inline")
    lr, n_rep, n = config.learning_rate, len(SEEDS), images.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        pool, labels = load_digit_pool()
        data = os.path.join(tmp, "data")
        generate_dataset(pool, labels, MultiMNISTConfig(
            images_per_digit=SEEDS_PER_STRATUM, test_set_size=SEEDS_TEST,
            seed=3), out_dir=data)
        say("seeds", card_line, f"generated {3 * SEEDS_PER_STRATUM} "
            f"canvases ({SEEDS_TEST} held out) for the sweep in "
            f"{time.perf_counter() - t:.1f} s")
        state0 = create_multi_seed_state(config, SEEDS, device=DEVICE)
        perms = multi_seed_perms(n, SEEDS, 0, device=DEVICE)
        check_seed_gradients(config, state0, images, digits, perms,
                             card_line)

        # the phase's main run: SEEDS_STEPS steps, SEEDS_K per call
        multi = make_multi_seed_step(config, SEEDS_K, BATCH)
        per_call = {k: SEEDS_K * v
                    for k, v in want_kernels("inline",
                                             config.max_steps).items()}
        state, losses, recons, first_k = state0, [], [], None
        reset_launches()
        timer = StepTimer(warmup=1)
        t = time.perf_counter()
        for i in range(0, SEEDS_STEPS, SEEDS_K):
            before = launches()
            with timer.step(SEEDS_K):
                state, m = multi(state, images, digits, perms, i)
                torch.cuda.synchronize()
            expect_launches(before, per_call, f"seed-parallel steps "
                            f"{i}-{i + SEEDS_K - 1}")
            losses.append(m["loss"].cpu())
            recons.append(m["reconstruction_loss"].cpu())
            if first_k is None:
                first_k = m["loss"].cpu()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        main_launches = {k: launches()[k] for k in per_call}
        losses, recons = torch.cat(losses).numpy(), torch.cat(recons).numpy()
        if not np.all(np.isfinite(losses)):
            fail(f"seed-parallel: non-finite losses {losses}")
        for r in range(n_rep):
            still = [path for (path, a), b in zip(
                tree_leaves_with_path(state.params),
                tree_leaves(state0.params)) if torch.equal(a[r], b[r])]
            first5 = float(np.mean(recons[:5, r]))
            last5 = float(np.mean(recons[-5:, r]))
            if still or not last5 < first5:
                fail(f"seed-parallel replica {r}: leaves that did not move "
                     f"{still}, or reconstruction loss of the last 5 steps "
                     f"{last5} not below the first 5 {first5}")
        main_digest = digest(tree_leaves(state.params))
        say("seeds", card_line, f"S={n_rep} {SEEDS_STEPS} seed-parallel "
            f"steps ({SEEDS_K} per call, one captured step replayed) in "
            f"{seconds:.2f} s (the first call, with the capture, "
            f"{timer.summary()['first_step_ms']:.1f} ms), launches="
            f"{main_launches}; per replica loss "
            + ", ".join(f"{losses[0, r]:.3f} -> {losses[-1, r]:.3f}"
                        for r in range(n_rep))
            + "; reconstruction loss of the last 5 steps below the first 5 "
            f"for every replica; every leaf of every replica moved; "
            f"params_sha256={main_digest}")

        # each replica against the single-seed run of its seed: the
        # losses over SEEDS_K steps, the params after one
        losses_k = first_k
        single = make_train_step(config)
        state_1, _ = make_multi_seed_step(config, 1, BATCH)(
            state0, images, digits, perms, 0)
        worst = (0.0, 0.0, 0.0, 0.0)
        for r, seed in enumerate(SEEDS):
            st, ls = create_train_state(config, seed=seed, device=DEVICE), []
            for i in range(SEEDS_K):
                lo = min(i * BATCH, n - BATCH)
                rows = perms[r, lo:lo + BATCH]
                st, m = single(st, images[rows], digits[rows])
                ls.append(float(m["loss"]))
                if i == 0:
                    apart = params_apart(
                        [a[r] for a in tree_leaves(state_1.params)],
                        tree_leaves(st.params), lr, 1)
            got = losses_k[:, r].numpy()
            rel = np.abs(got - ls) / np.abs(ls)
            drift = abs(float(np.mean(got)) / float(np.mean(ls)) - 1.0)
            if not (rel[:2].max() <= SEED_LOSS_TOL
                    and drift <= SEED_DRIFT_TOL):
                fail(f"seed-parallel replica {r} vs the single-seed run of "
                     f"seed {seed}: losses {got.tolist()} vs {ls} (rel "
                     f"{rel.tolist()}; tol {SEED_LOSS_TOL} at steps 0-1; "
                     f"means {drift} apart, tol {SEED_DRIFT_TOL})")
            worst = tuple(max(x, y) for x, y in
                          zip(worst, (rel[:2].max(), drift, *apart)))
        say("seeds", card_line, f"each of the {n_rep} replicas against "
            f"{SEEDS_K} single-seed steps of its seed: losses max rel diff "
            f"{worst[0]:.3g} at steps 0-1 (tol {SEED_LOSS_TOL}), mean loss "
            f"over the {SEEDS_K} steps {worst[1]:.3g} apart (tol "
            f"{SEED_DRIFT_TOL}); params after step 0 max |diff| "
            f"{worst[2]:.3g} (bound {2 * lr:.3g}), mean |diff| "
            f"{worst[3]:.3g} (bound {lr * 2 ** -7:.3g})")

        runs = []
        for _ in range(2):
            st, m = make_multi_seed_step(config, DETERMINISM_STEPS, BATCH)(
                state0, images, digits, perms, 0)
            runs.append((m["loss"].view(torch.int32).tolist(),
                         digest(tree_leaves(st.params))))
        if runs[0] != runs[1]:
            fail(f"seed-parallel: two runs of {DETERMINISM_STEPS} steps from "
                 "the same state part")
        fresh = create_train_state(config, seed=99, device=DEVICE)
        moved = reinit_replica(state, config, 1, seed=99)
        for a, b, f in zip(tree_leaves(moved.params),
                           tree_leaves(state.params),
                           tree_leaves(fresh.params)):
            if not (all(torch.equal(a[r], b[r]) for r in (0, 2, 3))
                    and torch.equal(a[1], f)):
                fail("reinit_replica touched a replica other than 1")
        if moved.step.tolist() != [SEEDS_STEPS, 0, SEEDS_STEPS, SEEDS_STEPS]:
            fail(f"reinit_replica clocks {moved.step.tolist()}")
        say("seeds", card_line, f"two runs of {DETERMINISM_STEPS} "
            f"seed-parallel steps from one state: losses and params "
            f"bit-equal; reinit_replica(1, seed=99) left replicas 0, 2, 3 "
            f"bit-equal and gave replica 1 the fresh init and clock 0")

        # the streamed-weight kernels 5-7 under the fold
        pallas = config.replace(st_impl="pallas")
        check_seed_gradients(pallas, state0, images, digits, perms,
                             card_line)
        reset_launches()
        before = launches()
        _, m_k = make_multi_seed_step(pallas, SEED_PALLAS_STEPS, BATCH)(
            state0, images, digits, perms, 0)
        torch.cuda.synchronize()
        expect_launches(before, {k: SEED_PALLAS_STEPS * v for k, v in
                                 want_kernels("pallas",
                                              config.max_steps).items()},
                        f"{SEED_PALLAS_STEPS} seed-parallel pallas steps")
        pallas_launches = launches()
        _, m_p = make_multi_seed_step(config.replace(st_impl="xla"),
                                      SEED_PALLAS_STEPS, BATCH)(
            state0, images, digits, perms, 0)
        rel = float(((m_k["loss"] - m_p["loss"]).abs()
                     / m_p["loss"].abs()).max())
        if not rel <= SEED_LOSS_TOL:
            fail(f"seed-parallel pallas vs plain path over "
                 f"{SEED_PALLAS_STEPS} steps: losses max rel {rel}")
        say("seeds", card_line, f"st_impl=pallas {SEED_PALLAS_STEPS} "
            f"seed-parallel steps: launches "
            f"{ {k: v for k, v in pallas_launches.items() if v} }, losses "
            f"against the plain path max rel {rel:.3g} (tol {SEED_LOSS_TOL})")

        check_sweep(data, tmp, card_line)
    return ({**main_launches, **{k: v for k, v in pallas_launches.items()
                                 if k not in main_launches}},
            (losses, main_digest))


def check_sweep(data: str, tmp: str, card_line: str) -> None:
    """``python -m air_tpu_torch.seed_sweep``'s entry point in this
    process: SEEDS on the generated set, SWEEP_ITERS steps, evals every
    SWEEP_EVERY."""
    out = os.path.join(tmp, "sweep")
    t = time.perf_counter()
    stdout = run_cli(["air_tpu_torch.seed_sweep",
                       *map(str, SEEDS), "--cnn", "--data", data,
                       "--out", out, "--max-iters", str(SWEEP_ITERS),
                       "--eval-every", str(SWEEP_EVERY),
                       "--multi-step", str(SWEEP_K)])
    seconds = time.perf_counter() - t
    with open(os.path.join(out, "results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    final = rows[len(SEEDS):]
    evals = [line for line in stdout.splitlines()
             if line.startswith("[eval @ ")]
    want_evals = [f"[eval @ {s}]" for s in range(0, SWEEP_ITERS + 1,
                                                 SWEEP_EVERY)]
    if (len(rows) != 2 * len(SEEDS)
            or not all(r.get("in_flight") for r in rows[:len(SEEDS)])
            or [r["seed"] for r in final] != list(SEEDS)
            or any(r["final_step"] != SWEEP_ITERS
                   or not np.isfinite(r["test_accuracy"]) for r in final)
            or [e.split(" s")[0] for e in evals] != want_evals
            or stdout.count("SWEEPRESULT ") != len(SEEDS)):
        sys.stderr.write(stdout[-4000:])
        fail(f"seed_sweep: rows {rows}, evals {evals}")
    say("seeds", card_line, f"python -m air_tpu_torch.seed_sweep "
        f"{' '.join(map(str, SEEDS))} --cnn: {SWEEP_ITERS} steps, evals "
        + "; ".join(evals) + f"; results.jsonl rows {final}; "
        f"{seconds:.1f} s")


def card_draws(seed: int, step: int, device: str | None = None) -> dict:
    """Every draw of one robust-default forward pass at batch 64 from
    ``step_generator(seed, step)`` on ``device`` (the card's by default)."""
    cfg = DEFAULT_TRAINING_CONFIG.replace(cnn=True)
    device = device or DEVICE
    return draw_noise(cfg, BATCH, step_generator(seed, step, device),
                      device)


def flat_draws(d: dict) -> np.ndarray:
    return torch.cat([d[k].reshape(-1) for k in DRAW_KEEP]).double().cpu(
        ).numpy()


def check_draws(card_line: str) -> None:
    """Phase 14 (a): the card's draws against the law, the CPU generator's
    draws, each other and the seed-parallel replicas."""
    from scipy import stats
    t = time.perf_counter()
    on_card = [card_draws(0, s) for s in range(DRAW_STEPS)]
    cpu = [card_draws(0, s, "cpu") for s in range(DRAW_STEPS)]
    lines = []
    for kind, n_steps in DRAW_KEEP.items():
        x = torch.stack([d[kind] for d in on_card[:n_steps]]).double().cpu(
            ).numpy().ravel()
        ref = torch.stack([d[kind] for d in cpu[:n_steps]]).double().numpy(
            ).ravel()
        law = stats.uniform() if kind == "z_pres_u" else stats.norm()
        mean, var = law.mean(), law.var()
        m4 = (law.moment(4) - 4 * mean * law.moment(3)
              + 6 * mean ** 2 * law.moment(2) - 3 * mean ** 4)
        n = x.size
        z_mean = (x.mean() - mean) / np.sqrt(var / n)
        z_var = (x.var() - var) / np.sqrt((m4 - var ** 2) / n)
        p_law = stats.kstest(x, law.cdf).pvalue
        p_cpu = stats.ks_2samp(x, ref).pvalue
        if (abs(z_mean) >= 5 or abs(z_var) >= 5 or p_law <= DRAW_P_MIN
                or p_cpu <= DRAW_P_MIN
                or (kind == "z_pres_u" and not 0.0 <= x.min() <= x.max()
                    < 1.0)):
            fail(f"draws: {kind} on the card, n={n}: mean {x.mean()} "
                 f"({z_mean:.2f} SE), var {x.var()} ({z_var:.2f} SE), KS "
                 f"p {p_law:.3g} against the law, {p_cpu:.3g} against the "
                 f"CPU generator")
        lines.append(f"{kind} n={n} mean {z_mean:+.2f} SE var {z_var:+.2f} "
                     f"SE KS p {p_law:.3f} (law) {p_cpu:.3f} (CPU)")
    u = torch.stack([d["z_pres_u"] for d in on_card])
    noise = logistic_noise(u).double().cpu().numpy().ravel()
    tails = []
    for tail in (2.0, 4.0, 6.0):
        p = 2.0 / (1.0 + np.exp(tail))
        got = float(np.mean(np.abs(noise) > tail))
        if abs(got - p) >= 5 * np.sqrt(p * (1 - p) / noise.size) \
                + 1.0 / noise.size:
            fail(f"draws: P(|L| > {tail}) = {got} on the card, logistic "
                 f"law {p}")
        tails.append(f"P(|L|>{tail:g}) {got:.5f} (law {p:.5f})")
    if not (np.all(np.isfinite(noise)) and np.abs(noise).max() < 21.0
            and stats.kstest(noise, stats.logistic().cdf).pvalue
            > DRAW_P_MIN):
        fail(f"draws: the card's logistic noise spans {noise.min()} .. "
             f"{noise.max()}")
    pairs = {"consecutive steps": ((0, 7), (0, 8)),
             "consecutive seeds": ((3, 5), (4, 5)),
             "attempt_seed": ((3, 5), (attempt_seed(3, 1), 5)),
             "eval stream": ((4, 2500), (4 ^ EVAL_SEED, 2500))}
    corr = []
    for what, ((sa, ka), (sb, kb)) in pairs.items():
        a, b = (flat_draws(card_draws(s_, k_)) for s_, k_ in
                ((sa, ka), (sb, kb)))
        r = float(np.corrcoef(a, b)[0, 1])
        if not abs(r) < 5 / np.sqrt(a.size):
            fail(f"draws: {what} correlate on the card, r = {r}")
        corr.append(f"{what} r={r:+.5f}")
    cfg = DEFAULT_TRAINING_CONFIG.replace(cnn=True)
    seeds, steps = [0, 1, attempt_seed(1, 1)], torch.tensor([7, 7, 0])
    stacked = replica_noise(cfg, BATCH, seeds, steps, DEVICE)
    for r, (seed, step) in enumerate(zip(seeds, steps.tolist())):
        again = card_draws(seed, step)
        if not all(torch.equal(stacked[k][r], again[k]) for k in again):
            fail(f"draws: replica {r} of the seed-parallel step is not "
                 f"step_generator({seed}, {step})'s stream")
    torch.cuda.synchronize()
    say("sweep", card_line, f"(a) draws of step_generator on the card, "
        f"{DRAW_STEPS} steps at batch {BATCH}: " + "; ".join(lines)
        + "; logistic noise " + ", ".join(tails) + f" over {noise.size}; "
        + ", ".join(corr) + "; the replicas draw their single-seed streams "
        f"bit for bit; {time.perf_counter() - t:.1f} s")


class RecordedTrainer(Trainer):
    """The trainer, keeping every instance made (the sweep makes its own)."""
    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        RecordedTrainer.made.append(self)


def check_sweep_single(card_line: str) -> dict:
    """Phase 14 (b). Returns the inline kernels' launches of the sweep."""
    with tempfile.TemporaryDirectory() as tmp:
        pool, labels = load_digit_pool()
        data = os.path.join(tmp, "data")
        generate_dataset(pool, labels, MultiMNISTConfig(
            images_per_digit=TRAINER_PER_STRATUM, test_set_size=TRAINER_TEST,
            seed=0), out_dir=data)
        out = os.path.join(tmp, "sweep")
        results = os.path.join(out, "results.jsonl")
        RecordedTrainer.made = []
        saved = trainer_module.Trainer
        trainer_module.Trainer = RecordedTrainer
        t = time.perf_counter()
        reset_launches()
        try:
            stdout = [run_cli([
                "air_tpu_torch.seed_sweep_single", str(seed), "--cnn", flag,
                "--data", data, "--out", out, "--max-iters",
                str(SINGLE_ITERS), "--eval-every", str(SINGLE_EVERY),
                "--device", DEVICE]) for seed, flag in SINGLE_SEEDS]
        finally:
            trainer_module.Trainer = saved
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        now = launches()
        fwd, bwd = PATHS["inline"]
        want = {k: 0 for k in now}
        for tr in RecordedTrainer.made:
            t_ = tr.config.max_steps
            steps = tr.calls["train"] + tr.calls["grad"]
            for k in fwd:
                want[k] += t_ * (steps + tr.calls["eval"])
            for k in bwd:
                want[k] += t_ * steps
        if (now != want or len(RecordedTrainer.made) != len(SINGLE_SEEDS)
                or any(now[k] == 0 for k in (*fwd, *bwd))):
            fail(f"seed_sweep_single launched {now}, expected {want}")
        with open(results) as f:
            rows = [json.loads(line) for line in f]
        tags = ["hold15000_cnn_temp", "hold15000_cnn_spc"]
        want_evals = list(range(0, SINGLE_ITERS + 1, SINGLE_EVERY))
        records_ = []
        for i, (seed, _) in enumerate(SINGLE_SEEDS):
            marker, row = rows[2 * i], rows[2 * i + 1]
            folder = os.path.join(out, f"seed{seed}_{tags[i]}")
            rec = ledger.extract(folder)
            records_.append(rec)
            if (not marker.get("in_flight") or row.get("in_flight")
                    or (marker["seed"], marker["tag"]) != (seed, tags[i])
                    or (row["seed"], row["tag"]) != (seed, tags[i])
                    or row["final_step"] != SINGLE_ITERS
                    or not np.isfinite(row["test_accuracy"])
                    or f"SWEEPRESULT {json.dumps(row)}" not in stdout[i]
                    or [s_ for s_, _ in rec["eval_trajectory"]] != want_evals
                    or rec["final_step"] != SINGLE_ITERS
                    or rec["final_accuracy"] != round(row["test_accuracy"],
                                                      4)):
                fail(f"seed_sweep_single seed {seed}: rows {rows}, ledger "
                     f"{rec}")
        with open(results, "a") as f:      # a third seed, cut in flight
            f.write(json.dumps({**rows[0], "seed": 2}) + "\n")
        table = run_cli(["air_tpu_torch.summarize_sweep", results])
        union = run_cli(["air_tpu_torch.summarize_sweep",
                         f"{results}:{tags[0]}", f"{results}:{tags[1]}"])
        body = [line for line in table.splitlines()[1:] if line.strip()]
        cut = [line for line in body if "[in flight at cut]" in line]
        # the union keeps each seed's best row: here the same rows
        if (len(body) != 4 or len(cut) != 1 or cut[0].split()[0] != "2"
                or not body[-1].startswith("converged: ")
                or "/3 " not in body[-1] or union != table):
            fail(f"summarize_sweep:\n{table}\n{union}")
    say("sweep", card_line, f"(b) python -m air_tpu_torch.seed_sweep_single "
        + ", ".join(f"{s} --cnn {f}" for s, f in SINGLE_SEEDS)
        + f": {SINGLE_ITERS} steps each in {seconds:.1f} s, launches "
        f"{now}; rows " + json.dumps(rows[1::2]) + "; ledger evals "
        + "; ".join(json.dumps(r["eval_trajectory"]) for r in records_)
        + "; summarize_sweep:\n" + table.rstrip())
    return now


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    card_line = card()

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say("device", card_line, f"name={kind} count={count} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")

    # 2. build: one nvcc per source, all started together
    t_build = time.perf_counter()
    libs = build.load_all()
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
    err = kernel_errors((BATCH, 1, 7), CS, WS, 0, "kernels", card_line)

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
    train_launches, eager_runs = {}, {}
    for impl in PATHS:
        got, eager_runs[impl] = check_train(train_cfg.replace(st_impl=impl),
                                            state0, images, digits,
                                            card_line)
        train_launches.update(got)

    # 6. times at B = 64
    sets = input_sets(BATCH, 1234, 4321)
    rows = []
    for kname, source, replaces in (
            ("inline_attention_read", "st_inline.cu", "st_inline.py:222"),
            ("inline_write_accumulate", "st_inline.cu", "st_inline.py:70"),
            ("inline_attention_read_bwd", "st_inline.cu", "st_inline.py:234"),
            ("inline_write_accumulate_bwd", "st_inline.cu", "st_inline.py:83"),
            ("fused_write_accumulate", "st_fused.cu", "st_fused.py:52"),
            ("fused_write_accumulate_bwd", "st_fused.cu", "st_fused.py:63"),
            ("pallas_attention_read", "st_pallas.cu", "st_pallas.py:41")):
        t = kernel_times(kname, sets)
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"air_tpu_torch/kernels/csrc/{source}",
            "replaces": f"air_tpu/kernels/{replaces}",
            "launches": train_launches[kname], "max_abs_err": err[kname],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
        say("times", card_line, f"{kname} B={BATCH}: " + times_line(t))
    # every kernel (the streamed-weight resample in both directions, the
    # streamed-weight write-accumulate forward and backward, the inline read,
    # write, read backward and write backward) at B = 1, 64, 256 and 1024,
    # each beside its library chain and its bound
    del sets
    for b in SWEEP_BATCHES:
        sets = input_sets(b, 2000 + b, 3000 + b)
        for kname in SWEPT:
            say("times", card_line, f"{kname} B={b}: "
                + times_line(kernel_times(kname, sets)))
        del sets

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

    # 7. the trainer
    trainer_launches = check_trainer(card_line)
    for row in rows:
        row["trainer_launches"] = trainer_launches.get(row["name"], 0)

    # 8. the paths of the JAX package's entry points, and the tools
    served = check_default_serving(canvases, truth, card_line)
    check_layout_train("decoder_layout=stepparallel",
                       train_cfg.replace(st_impl="xla",
                                         decoder_layout="stepparallel"),
                       state0, images, digits, card_line)
    check_layout_train("compute_dtype=bfloat16",
                       train_cfg.replace(st_impl="inline",
                                         compute_dtype="bfloat16"),
                       state0, images, digits, card_line)
    check_tools(card_line)
    for label, wrapper in {"inline scan " + os.path.basename(CKPT):
                           wrappers["inline"], **served}.items():
        lat = {n: infer_latency(wrapper, canvases, n) for n in (1, 64)}
        kern = {n: kernels_per_infer(wrapper, canvases, n) for n in (1, 64)}
        say("layouts", card_line, f"serve {label} "
            f"({wrapper.config.decoder_layout}, st_impl="
            f"{wrapper.config.st_impl}, {wrapper.config.compute_dtype}): "
            f"infer latency median of 10: 1 canvas {lat[1]:.3f} ms, 64 "
            f"canvases {lat[64]:.3f} ms; kernels and copies per infer: "
            f"{kern[1]:.0f} (1 canvas), {kern[64]:.0f} (64)")

    # 9. seed-parallel training
    seed_launches, seeds_run = check_seeds(train_cfg, images, digits,
                                           card_line)
    for row in rows:
        row["seeds_launches"] = seed_launches.get(row["name"], 0)

    # 10. the captured train step against the eager one
    captured_launches, single_ms = check_captured(
        train_cfg, state0, images, digits, eager_runs, seeds_run, card_line)
    for row in rows:
        row["captured_launches"] = captured_launches.get(row["name"], 0)

    # 11. multi-device training, its ranks on the one card
    parallel_launches = check_parallel(train_cfg, images, digits, eager_runs,
                                       single_ms, card_line)
    for row in rows:
        row["parallel_launches"] = parallel_launches.get(row["name"], 0)

    # 12. pipeline_unroll, and the real-handwriting path
    unrolled_launches = check_unrolled(train_cfg, state0, images, digits,
                                       eager_runs["inline"], seeds_run,
                                       card_line)
    real_launches = check_real_handwriting(card_line)
    for row in rows:
        row["unrolled_launches"] = unrolled_launches.get(row["name"], 0)
        row["real_launches"] = real_launches.get(row["name"], 0)

    # 13. the scaled and the harder configurations
    scaled_times, config_launches = check_configs(libs, card_line)
    for row in rows:
        row["configs_launches"] = config_launches.get(row["name"], 0)
        row.update({f"scaled_{k}": scaled_times[row["name"]][k]
                    for k in ("ms", "bound_ms", "library_ms")})

    # 14. the card's draws and the sequential sweep
    check_draws(card_line)
    sweep_launches = check_sweep_single(card_line)
    for row in rows:
        row["sweep_single_launches"] = sweep_launches.get(row["name"], 0)

    elapsed = time.perf_counter() - T0
    if elapsed > TIME_BUDGET_S:
        print(f"note: {elapsed:.0f}s is over the {TIME_BUDGET_S:.0f}s budget",
              file=sys.stderr, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
