"""Sequential robustness sweep of the port: train one seed at a single fixed
configuration through the trainer and append the outcome to a JSONL ledger.

    for s in $(seq 0 9); do
        python -m air_tpu_torch.seed_sweep_single $s --cnn \\
            --stall-restart 60000 --out seq_sweep
    done

The flags, defaults and tag rule of the JAX package's
``scripts/seed_sweep.py``: the reference hyperparameters plus the
hold-then-decay z_pres prior schedule (``--hold``), optionally the z_pres
temperature anneal (``--temp-anneal``) and the scale-prior curriculum
(``--scale-prior-curriculum``); the trainer's device-data loop (50 steps a
host iteration), stall restarts re-seeded with ``--attempt-stride`` and the
rotated bootstrap schedules. Plus ``--device`` (default ``cuda``; ``cpu``
for a tiny run without a card), ``--st-impl`` (default ``inline``: kernels
1-4 in every train step, 1-2 in every eval) and ``--synthetic-data N``
(if ``--data`` holds no set, generate one first, N canvases per digit
count). ``--data`` defaults to ``multi_mnist_data`` and ``--out`` to
``seq_sweep`` beside it (a name outside the JAX package's ``sweep_*``
ledgers, which ``scripts/check_provenance.py`` reads).

``results.jsonl`` in ``--out`` gets an in-flight row when the seed starts
and its result row when it ends (also printed as a ``SWEEPRESULT`` line);
``python -m air_tpu_torch.summarize_sweep`` drops the in-flight row once
the result lands, so a seed cut by a time limit stays visible.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("seed", type=int)
    p.add_argument("--data", default="multi_mnist_data")
    p.add_argument("--out", default="seq_sweep")
    p.add_argument("--hold", type=int, default=15000)
    p.add_argument("--max-iters", type=int, default=250000)
    p.add_argument("--stop-acc", type=float, default=0.98)
    p.add_argument("--eval-every", type=int, default=2500)
    p.add_argument("--temp-anneal", action="store_true",
                   help="also anneal z_pres temperature 5 -> 1 over the "
                        "hold window (stall-basin remedy candidate)")
    p.add_argument("--scale-prior-curriculum", action="store_true",
                   help="anneal scale_prior_mean 0 -> -1 over 30k steps")
    p.add_argument("--stall-restart", type=int, default=0,
                   help="enable auto-recovery: restart re-seeded if "
                        "accuracy < 0.75 at this step (0 = off)")
    p.add_argument("--rotate", type=int, choices=[0, 1], default=1,
                   help="rotate the bootstrap schedule across restart "
                        "attempts (DEFAULT_RESTART_ROTATION)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--attempt-stride", type=int, default=1009,
                   help="attempt_seed stride: restart n trains at seed + "
                        "stride*n")
    p.add_argument("--cnn", action="store_true",
                   help="train with the CNN encoder (the reference "
                        "constructor default)")
    p.add_argument("--adam-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="Adam moment storage override (default: shipped "
                        "config default)")
    p.add_argument("--unroll", type=int, default=None,
                   help="scan_unroll override (kept for parity; the port's "
                        "attention loop is a Python loop)")
    p.add_argument("--tag", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for a tiny run without a card)")
    p.add_argument("--st-impl", default="inline",
                   choices=["inline", "pallas", "xla"],
                   help="attention read/write path: inline (kernels 1-4), "
                        "pallas (streamed-weight kernels 5-7) or xla "
                        "(plain products, no kernel)")
    p.add_argument("--synthetic-data", type=int, default=0,
                   help="if --data holds no set, generate one with N "
                        "images per digit stratum first")
    return p


def sweep_config(args):
    """(model config, tag) from the flags, as the JAX script builds them."""
    from air_tpu_torch.models.config import (DEFAULT_TRAINING_CONFIG,
                                             pin_raw_pixel_numerics)
    sched = DEFAULT_TRAINING_CONFIG.schedules
    if args.hold:
        sched["z_pres_prior_log_odds"]["hold"] = args.hold
    if args.temp_anneal:
        sched["z_pres_temperature"] = {
            "init": 5.0, "min": 1.0, "factor": 0.5,
            "iters": max(args.hold // 3, 3000), "log": False}
    if args.scale_prior_curriculum:
        # big windows early, the reference prior late: the mean decays
        # 0 -> -1 (init 1 with offset -1, halving every 5k steps)
        sched["scale_prior_mean"] = {
            "init": 1.0, "min": 0.0, "factor": 0.5, "iters": 5000,
            "offset": -1.0}
    cfg = DEFAULT_TRAINING_CONFIG.replace(
        annealing_schedules=sched, cnn=args.cnn, st_impl=args.st_impl,
        **pin_raw_pixel_numerics(args.cnn, args.adam_dtype, args.unroll))
    tag = args.tag or (f"hold{args.hold}"
                       + ("_cnn" if args.cnn else "")
                       + ("_temp" if args.temp_anneal else "")
                       + ("_spc" if args.scale_prior_curriculum else ""))
    return cfg, tag


def trainer_config(args, folder: str):
    """The trainer's config of one seed, the JAX script's."""
    from air_tpu_torch.train.trainer import (DEFAULT_RESTART_ROTATION,
                                             TrainerConfig)
    return TrainerConfig(
        results_folder=folder, overwrite_results=True,
        batch_size=64, epochs=None, max_iterations=args.max_iters,
        stop_at_accuracy=args.stop_acc,
        num_summaries_every=args.eval_every,
        img_summaries_every=10 ** 9, grad_summaries_every=0,
        var_summaries_every=10 ** 9,
        save_params_every=10 ** 9, eval_batch_size=1000,
        seed=args.seed, log_every=args.eval_every * 10,
        source_snapshot=False, device_data=True, multi_step=50,
        stall_detect_step=args.stall_restart or None,
        max_restarts=args.max_restarts,
        attempt_seed_stride=args.attempt_stride,
        restart_schedule_rotation=(
            DEFAULT_RESTART_ROTATION if args.rotate else ()),
        device=args.device)


def main(argv=None) -> dict:
    """Train the seed; returns its result row."""
    args = build_parser().parse_args(argv)

    from air_tpu_torch.data.loader import load_test_data
    from air_tpu_torch.train.trainer import Trainer
    from air_tpu_torch.training import synthesize

    train_path = os.path.join(args.data, "common.airrec")
    if args.synthetic_data and not os.path.exists(train_path):
        synthesize(args.data, args.synthetic_data)
    cfg, tag = sweep_config(args)
    folder = os.path.join(args.out, f"seed{args.seed}_{tag}")
    tcfg = trainer_config(args, folder)

    # the in-flight row first: a cut or crashed seed leaves a visible row
    # (summarize_sweep drops it once the result row lands)
    os.makedirs(args.out, exist_ok=True)
    results = os.path.join(args.out, "results.jsonl")
    with open(results, "a") as f:
        f.write(json.dumps({
            "seed": args.seed, "tag": tag, "in_flight": True,
            "final_step": 0, "test_accuracy": 0.0, "converged": False,
            "restarts": 0, "wall_minutes": 0.0}) + "\n")

    test = load_test_data(os.path.join(args.data, "test.airrec"))
    t0 = time.time()
    result = Trainer(cfg, tcfg, train_path, test).train()
    rec = {
        "seed": args.seed, "tag": tag,
        "final_step": result["step"],
        "test_accuracy": result["test_accuracy"],
        "converged": result["test_accuracy"] >= args.stop_acc,
        "restarts": result.get("restarts", 0),
        "wall_minutes": round((time.time() - t0) / 60, 1),
    }
    with open(results, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("SWEEPRESULT " + json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
