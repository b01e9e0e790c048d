"""Summarize robustness-sweep ledgers (``seed_sweep_single`` and
``seed_sweep`` output); the JAX package's ``scripts/summarize_sweep.py``,
with its arguments and output.

Single ledger (per-seed table and tally, later re-runs supersede):
    python -m air_tpu_torch.summarize_sweep seq_sweep/results.jsonl

Union across ledgers or tags (per seed the BEST attempt: converged first,
then the highest accuracy):
    python -m air_tpu_torch.summarize_sweep \\
        sweep_vmap/results.jsonl:vmap_hold15000_cnn_rot \\
        seq_sweep/results.jsonl:hold15000_cnn_spc
A ``path:tag`` argument keeps only that tag's rows; bare paths keep all.
"""

from __future__ import annotations

import json
import sys


def load(arg: str) -> list:
    """The rows of ``path`` or ``path:tag``, each marked with its source."""
    path, _, tag = arg.partition(":")
    rows = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if not tag or r.get("tag") == tag:
                r["_src"] = arg
                rows.append(r)
    return rows


def summarize(args: list) -> list:
    """The rows that stand, sorted by (seed, tag)."""
    union = len(args) > 1 or any(":" in a for a in args)
    rows = {}
    for arg in args:
        for r in load(arg):
            key = (r["seed"],) if union else (r["seed"], r["tag"])
            prev = rows.get(key)
            # an in-flight row never supersedes a real result, and any
            # real result supersedes it
            if prev is not None and r.get("in_flight") \
                    and not prev.get("in_flight"):
                continue
            if prev is not None and prev.get("in_flight") \
                    and not r.get("in_flight"):
                rows[key] = r
                continue
            # single ledger: later rows (re-runs) supersede; union: keep
            # the best attempt (converged beats not, then accuracy)
            if prev is None or not union or (
                    (r["converged"], r["test_accuracy"])
                    > (prev["converged"], prev["test_accuracy"])):
                rows[key] = r
    return sorted(rows.values(), key=lambda r: (r["seed"], r["tag"]))


def main(argv=None) -> list:
    args = (sys.argv[1:] if argv is None else list(argv)) \
        or ["seq_sweep/results.jsonl"]
    rows = summarize(args)
    n_conv = sum(r["converged"] for r in rows)
    print(f"{'seed':>4} {'tag':<26} {'steps':>8} {'acc':>6} "
          f"{'restarts':>8} {'min':>6}")
    for r in rows:
        flag = "  [in flight at cut]" if r.get("in_flight") else ""
        print(f"{r['seed']:>4} {r['tag']:<26} {r['final_step']:>8} "
              f"{r['test_accuracy']:>6.3f} {r['restarts']:>8} "
              f"{r['wall_minutes']:>6.1f}{flag}")
    print(f"\nconverged: {n_conv}/{len(rows)}  "
          f"(threshold: per-run stop_acc, default 0.98)")
    return rows


if __name__ == "__main__":
    main()
