"""Seed-parallel robustness sweep of the port: S seeds trained at once on
one card (``air_tpu_torch.train.multi_seed``), each replica's test accuracy
tracked to the bar.

    python -m air_tpu_torch.seed_sweep 0 1 2 3 4 5 6 7 8 9 \\
        --data multi_mnist_data --out sweep_vmap --hold 15000 --cnn

The flags and defaults of the JAX package's ``scripts/seed_sweep_vmap.py``,
plus ``--device`` (default ``cuda``; ``cpu`` for a tiny run without a
card), ``--st-impl`` (default ``inline``: kernels 1-4 folded over the S*B
images of every train step, 1-2 in every eval) and ``--synthetic-data N``
(if ``--data`` holds no set, generate one first, N canvases per digit
count, as ``python -m air_tpu_torch.training`` does). ``--pipeline-unroll
U`` is taken (an int >= 1) and tags the rows as the JAX script does; each
step stays one replay of the captured step, with the bits of U = 1.

The loop is the JAX script's: K-step chunks up to each eval, and a
shorter chunk off the cadence, where the JAX script runs single steps;
every chunk replays one captured seed-parallel step (``make_multi_seed_step``)
once per step. Every ``--eval-every`` steps each replica's test accuracy
(at its own clock and knobs, draws from ``(EVAL_SEED, step)``); a replica
flat below ``--stall-accuracy`` past ``--stall-restart`` is re-seeded (a
new param seed and data order, ``attempt_seed``) and, with ``--rotate``,
given the next bootstrap-schedule variant, while the others train on.
``results.jsonl`` in ``--out`` gets an in-flight marker row per seed at
the start and a final row per seed at the end (or a crash row), each also
printed as a ``SWEEPRESULT`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("seeds", type=int, nargs="+")
    p.add_argument("--data", default="multi_mnist_data")
    p.add_argument("--out", default="sweep_vmap")
    p.add_argument("--hold", type=int, default=15000)
    p.add_argument("--cnn", action="store_true")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--multi-step", type=int, default=50)
    p.add_argument("--max-iters", type=int, default=150000)
    p.add_argument("--stop-acc", type=float, default=0.98)
    p.add_argument("--eval-every", type=int, default=2500)
    p.add_argument("--eval-batch", type=int, default=500)
    p.add_argument("--stall-restart", type=int, default=60000,
                   help="replica step from which a flat sub-threshold "
                        "replica is re-seeded (0 = off)")
    p.add_argument("--stall-accuracy", type=float, default=0.95)
    p.add_argument("--stall-window", type=int, default=20000)
    p.add_argument("--stall-min-progress", type=float, default=0.01)
    p.add_argument("--stall-spare", type=float, default=0.85,
                   help="a replica at/above this accuracy is in the good "
                        "basin and is never re-seeded; 0 = off")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--attempt-stride", type=int, default=1009,
                   help="attempt_seed stride: restart n of a replica "
                        "trains at seed + stride*n (nonzero)")
    p.add_argument("--post-restart-iters", type=int, default=80000,
                   help="guarantee a re-seeded replica at least this many "
                        "further shared steps before the sweep ends; hard "
                        "cap 2x --max-iters")
    p.add_argument("--scale-curriculum", action="store_true",
                   help="overlay the scale-prior curriculum on the base "
                        "attempt")
    p.add_argument("--rotate", type=int, choices=[0, 1], default=1,
                   help="rotate bootstrap-schedule variants across restarts "
                        "per replica (schedule knobs, "
                        "multi_seed.vmap_rotation_variant); 0 = re-seed only")
    p.add_argument("--adam-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="Adam moment storage dtype override")
    p.add_argument("--unroll", type=int, default=None,
                   help="scan_unroll override (kept for parity; the port's "
                        "attention loop is a Python loop)")
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="AIRConfig.compute_dtype override")
    p.add_argument("--pipeline-unroll", type=int, default=1,
                   help="the JAX package's K-step scan unroll; the port "
                        "takes any U >= 1 and replays one step at a time, "
                        "with the bits of 1")
    p.add_argument("--decoder-layout", default=None,
                   choices=["scan", "stepparallel"],
                   help="AIRConfig.decoder_layout (stepparallel needs "
                        "--st-impl xla)")
    p.add_argument("--rnn-input-hoist", action="store_true",
                   help="AIRConfig.rnn_input_hoist")
    p.add_argument("--anneal-iters", type=int, default=None,
                   help="decade length of the z_pres prior log-odds "
                        "schedule; default keeps the reference 3000")
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
    if args.anneal_iters:
        sched["z_pres_prior_log_odds"]["iters"] = args.anneal_iters
    if args.scale_curriculum and not args.rotate:
        # with --rotate the knob-based schedules carry this instead
        sched["scale_prior_mean"] = {"init": 1.0, "min": 0.0, "factor": 0.5,
                                     "iters": 5000, "offset": -1.0,
                                     "hold": args.hold}
    cfg = DEFAULT_TRAINING_CONFIG.replace(
        annealing_schedules=sched, cnn=args.cnn, st_impl=args.st_impl,
        **pin_raw_pixel_numerics(args.cnn, args.adam_dtype, args.unroll),
        **({"compute_dtype": args.compute_dtype}
           if args.compute_dtype else {}),
        **({"decoder_layout": args.decoder_layout}
           if args.decoder_layout else {}),
        **({"rnn_input_hoist": True} if args.rnn_input_hoist else {}))
    tag = args.tag or ("vmap_hold%d%s%s%s%s%s%s%s%s%s%s" % (
        args.hold, "_cnn" if args.cnn else "",
        "_scalecur" if args.scale_curriculum else "",
        "_rot" if args.rotate else "",
        "_" + args.adam_dtype if args.adam_dtype else "",
        "_unroll%d" % args.unroll if args.unroll is not None else "",
        "_bf16c" if args.compute_dtype == "bfloat16" else "",
        "_pu%d" % args.pipeline_unroll
        if args.pipeline_unroll != 1 else "",
        "_ai%d" % args.anneal_iters if args.anneal_iters else "",
        "_sp" if args.decoder_layout == "stepparallel" else "",
        "_hx" if args.rnn_input_hoist else ""))
    return cfg, tag


def main(argv=None) -> dict:
    """Run the sweep. Returns its final rows, the stacked state and the
    replicas' current seeds."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.attempt_stride == 0:
        parser.error("--attempt-stride must be nonzero")

    import numpy as np
    import torch

    from air_tpu_torch.data.loader import load_test_data
    from air_tpu_torch.data.records import read_records
    from air_tpu_torch.train.multi_seed import (
        EVAL_SEED, create_multi_seed_state, evaluate_replicas,
        make_multi_seed_eval, make_multi_seed_step, multi_seed_perms,
        reinit_replica, rotation_knobs, rotation_variant_index,
        set_replica_knobs, stack_knobs, vmap_rotation_variant)
    from air_tpu_torch.train.trainer import attempt_seed, is_stalled
    from air_tpu_torch.training import synthesize

    train_path = os.path.join(args.data, "common.airrec")
    if args.synthetic_data and not os.path.exists(train_path):
        synthesize(args.data, args.synthetic_data)
    cfg, tag = sweep_config(args)
    device = torch.device(args.device)

    rec = read_records(train_path)
    images, digits = (
        torch.from_numpy(np.require(a, dtype, requirements="W")).to(device)
        for a, dtype in ((rec["images"].reshape(len(rec["images"]), -1),
                          np.float32), (rec["digits"], np.int32)))
    test_images, test_digits = load_test_data(
        os.path.join(args.data, "test.airrec"), shift_zero_digits_images=True)
    n = len(images)
    B = args.batch_size
    batches_per_epoch = n // B
    # a K above batches_per_epoch would make the off-cadence single steps
    # the steady state
    K = min(args.multi_step, batches_per_epoch)
    if K < args.multi_step:
        print(f"clamping K {args.multi_step} -> {K} "
              f"(only {batches_per_epoch} batches/epoch)")

    S = len(args.seeds)
    seeds = list(args.seeds)           # current data/param seed per replica
    state = create_multi_seed_state(cfg, seeds, device=device)
    multi = make_multi_seed_step(cfg, K, B, knob_schedules=bool(args.rotate),
                                 pipeline_unroll=args.pipeline_unroll)
    eval_fn = make_multi_seed_eval(cfg, knob_schedules=bool(args.rotate))
    knobs_S = None
    if args.rotate:
        base_knobs = rotation_knobs(args.hold,
                                    scale_curriculum=args.scale_curriculum)
        knobs_S = stack_knobs([base_knobs] * S)

    print(f"seed-parallel sweep: S={S} seeds={args.seeds} batch={B} K={K} "
          f"st_impl={args.st_impl} device={device} tag={tag}", flush=True)

    # in-flight markers at the start: a cut or crashed sweep leaves rows
    os.makedirs(args.out, exist_ok=True)
    results = os.path.join(args.out, "results.jsonl")
    with open(results, "a") as f:
        for sd in args.seeds:
            f.write(json.dumps({
                "seed": sd, "tag": tag, "in_flight": True,
                "final_step": 0, "test_accuracy": 0.0, "converged": False,
                "restarts": 0, "wall_minutes": 0.0}) + "\n")

    restarts = [0] * S
    conv_step = [None] * S             # replica-clock step at convergence
    final_acc = [0.0] * S
    best_acc = [0.0] * S               # across all attempts (never reset)
    history = [[] for _ in range(S)]   # (replica_step, acc)
    epoch, index = 0, 0
    perms = multi_seed_perms(n, seeds, epoch, device=device)
    step = 0                           # shared wall clock (loop steps)
    max_iters = args.max_iters         # extended on late restarts
    hard_cap = 2 * args.max_iters
    t0 = time.time()

    def run_eval():
        """Eval and convergence bookkeeping; True once all replicas are
        done. Each replica's hyperparameters resolve at its own clock and
        knobs."""
        rsteps = state.step.tolist()
        acc, _ = evaluate_replicas(cfg, state, test_images, test_digits,
                                   (EVAL_SEED, step),
                                   batch_size=args.eval_batch,
                                   eval_fn=eval_fn, knobs_S=knobs_S)
        line = " ".join(f"s{sd}:{a:.3f}" for sd, a in zip(args.seeds, acc))
        print(f"[eval @ {step}] {line}", flush=True)
        for r in range(S):
            # final_acc freezes at convergence: the replica trains on with
            # the pack, and a later dip must not overwrite it
            if conv_step[r] is None:
                final_acc[r] = float(acc[r])
            best_acc[r] = max(best_acc[r], float(acc[r]))
            history[r].append((int(rsteps[r]), float(acc[r])))
            if conv_step[r] is None and acc[r] >= args.stop_acc:
                conv_step[r] = int(rsteps[r])
                print(f"  seed {args.seeds[r]} converged at replica "
                      f"step {conv_step[r]} ({acc[r]:.3f})")
        return all(c is not None for c in conv_step)

    rows = []

    def write_rows(crashed=False, error=None):
        """Final (or crash-time) rows: on a crash the replica steps come
        from the eval history, the accuracy is the best of all attempts,
        and the row carries the exception text."""
        wall = time.time() - t0
        if crashed:
            rsteps = [history[r][-1][0] if history[r] else 0
                      for r in range(S)]
        else:
            rsteps = state.step.tolist()
        os.makedirs(args.out, exist_ok=True)
        with open(results, "a") as f:
            for r in range(S):
                rec_out = {
                    "seed": args.seeds[r], "tag": tag,
                    "final_step": int(conv_step[r]
                                      if conv_step[r] is not None
                                      else rsteps[r]),
                    "test_accuracy": (best_acc[r] if crashed
                                      else final_acc[r]),
                    "converged": conv_step[r] is not None
                    or final_acc[r] >= args.stop_acc,
                    "restarts": restarts[r],
                    # the bootstrap-schedule variant of the final attempt
                    "variant": ("base" if not args.rotate
                                or restarts[r] == 0
                                else rotation_variant_index(restarts[r])),
                    "wall_minutes": round(wall / 60, 1),
                }
                if crashed:
                    rec_out["crashed"] = True
                    if error:
                        rec_out["error"] = error
                f.write(json.dumps(rec_out) + "\n")
                rows.append(rec_out)
                print("SWEEPRESULT " + json.dumps(rec_out))
        agg = sum(1 for r in range(S)
                  if conv_step[r] is not None or final_acc[r] >= args.stop_acc)
        print(f"{agg}/{S} converged in {wall / 60:.1f} min total "
              f"({wall / 60 / S:.1f} min/seed equivalent)"
              + (" [CRASHED]" if crashed else ""))

    last_eval = -1
    try:
        while step < max_iters:
            if step % args.eval_every == 0:
                last_eval = step
                if run_eval():
                    print("all replicas converged")
                    break
                # per-replica stall recovery
                if args.stall_restart:
                    for r in range(S):
                        if conv_step[r] is not None or \
                                restarts[r] >= args.max_restarts:
                            continue
                        rs, a = history[r][-1]
                        # the Trainer's slope-based policy
                        if not is_stalled(history[r], rs, a,
                                          args.stall_restart,
                                          args.stall_accuracy,
                                          args.stall_window,
                                          args.stall_min_progress,
                                          args.stall_spare):
                            continue
                        restarts[r] += 1
                        new_seed = attempt_seed(args.seeds[r], restarts[r],
                                                args.attempt_stride)
                        variant = ""
                        if knobs_S is not None:
                            vk = vmap_rotation_variant(restarts[r],
                                                       args.hold)
                            knobs_S = set_replica_knobs(knobs_S, r, vk)
                            variant = (
                                " variant "
                                f"{rotation_variant_index(restarts[r])}"
                                f" {vk}")
                        print(f"  [stall] seed {args.seeds[r]} flat at "
                              f"{a:.3f} (replica step {rs}) -> reinit "
                              f"with seed {new_seed} (restart "
                              f"{restarts[r]}/{args.max_restarts})"
                              f"{variant}")
                        state = reinit_replica(state, cfg, r, new_seed)
                        seeds[r] = new_seed
                        perms[r] = multi_seed_perms(n, [new_seed], epoch,
                                                    device=device)[0]
                        history[r] = []
                        max_iters = min(hard_cap,
                                        max(max_iters,
                                            step + args.post_restart_iters))

            remaining = batches_per_epoch - index
            if remaining <= 0:
                epoch += 1
                index = 0
                perms = multi_seed_perms(n, seeds, epoch, device=device)
                remaining = batches_per_epoch
            k = min(K, remaining,
                    ((step // args.eval_every) + 1) * args.eval_every - step,
                    max_iters - step)
            # an off-cadence remainder replays the same captured step
            state, _ = multi(state, images, digits, perms, index, knobs_S,
                             num_steps=k)
            index += k
            step += k

        if last_eval != step and not all(c is not None for c in conv_step):
            # the loop ended at max_iters after the last eval: the accuracy
            # at the true final step
            run_eval()
    except BaseException as e:
        write_rows(crashed=True,
                   error=f"{type(e).__name__}: {e}"[:300])
        raise
    write_rows()
    return {"rows": rows, "state": state, "seeds": seeds, "steps": step}


if __name__ == "__main__":
    main()
