"""Extract a compact, committable record from a training run's results
folder (``summary/metrics.jsonl``); the JAX package's ``scripts/ledger.py``,
with its arguments and output.

    python -m air_tpu_torch.ledger RESULTS_FOLDER [--name NAME] \\
        [--out torch_runs/ledgers/NAME.json] [--note "..."]

Writes one JSON file: the eval-accuracy trajectory (downsampled to at most
200 points, the best and the final kept), best and final accuracy and
step, the stall restarts' recovery events, and an optional free-text note
recording the command. The record goes under ``torch_runs/ledgers/`` by
default, beside the JAX package's ledgers and not among them.
"""

from __future__ import annotations

import argparse
import json
import os


def extract(folder: str) -> dict:
    path = os.path.join(folder, "summary", "metrics.jsonl")
    evals = []            # (step, accuracy) in write order
    recovery = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if "test/accuracy" in r:
                evals.append((int(r["step"]), float(r["test/accuracy"])))
            if "recovery/attempt_ended" in r:
                recovery.append({
                    "attempt": int(r["recovery/attempt_ended"]),
                    "stalled_at_step": int(r["step"]),
                    "stalled_accuracy":
                        round(float(r["recovery/stalled_accuracy"]), 4),
                    "next_variant": int(r["recovery/next_variant"])})
    if not evals:
        raise SystemExit(f"no test/accuracy rows in {path}")
    best_step, best_acc = max(evals, key=lambda e: e[1])
    # <= 200 evenly spaced points, always with the best and the final one
    stride = max(1, len(evals) // 200)
    keep = set(range(0, len(evals), stride)) | {len(evals) - 1,
                                                evals.index((best_step,
                                                             best_acc))}
    traj = [evals[i] for i in sorted(keep)]
    return {
        "folder": folder,
        "final_step": evals[-1][0],
        "final_accuracy": round(evals[-1][1], 4),
        "best_accuracy": round(best_acc, 4),
        "best_step": best_step,
        "n_evals": len(evals),
        "restarts": len(recovery),
        "recovery_events": recovery,
        "eval_trajectory": [[s, round(a, 4)] for s, a in traj],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("folder")
    p.add_argument("--name", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--note", default="")
    args = p.parse_args(argv)
    name = args.name or os.path.basename(os.path.normpath(args.folder))
    rec = extract(args.folder)
    rec["name"] = name
    if args.note:
        rec["note"] = args.note
    out = args.out or os.path.join("torch_runs", "ledgers", f"{name}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"{out}: best {rec['best_accuracy']} @ {rec['best_step']}, "
          f"final {rec['final_accuracy']} @ {rec['final_step']}, "
          f"{rec['restarts']} restarts")
    return rec


if __name__ == "__main__":
    main()
