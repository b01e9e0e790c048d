"""The port's sweep summary and run ledger (air_tpu_torch.summarize_sweep,
air_tpu_torch.ledger) against the JAX package's scripts/summarize_sweep.py
and scripts/ledger.py: byte-equal output on the committed sweep ledgers,
single and as ``path:tag`` unions, and on metrics.jsonl files with
recovery events."""

import json
import os
import sys

import pytest

from air_tpu_torch import ledger, summarize_sweep
from tests.test_torch_sweep_single import load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R2 = os.path.join(REPO, "sweep_r2", "results.jsonl")
VMAP = os.path.join(REPO, "sweep_vmap", "results.jsonl")
R3 = os.path.join(REPO, "sweep_r3_rescue", "results.jsonl")
R3_RUN = os.path.join(REPO, "sweep_r3_rescue", "seed1_rescue_spc_rot")

SUMMARIES = [
    [R2],
    [VMAP],
    [R3],
    [R2 + ":hold15000_cnn"],
    [VMAP + ":vmap_hold15000_cnn", R3 + ":rescue_spc_rot"],
    [R2, VMAP, R3],
    [VMAP + ":vmap_hold15000_cnn_bf16c", VMAP + ":vmap_hold15000_cnn"],
]


@pytest.mark.parametrize("args", SUMMARIES, ids=lambda a: " ".join(
    os.path.relpath(p, REPO) for p in a))
def test_summary_is_byte_equal(args, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["summarize_sweep.py", *args])
    load_script("summarize_sweep").main()
    want = capsys.readouterr().out
    summarize_sweep.main(args)
    assert capsys.readouterr().out == want


def test_summary_supersedes_in_flight_rows(tmp_path, capsys):
    """A seed's in-flight row stands until its result lands, a later
    in-flight row never hides a result, and in a single ledger a re-run
    supersedes; the union keeps the best attempt."""
    path = str(tmp_path / "results.jsonl")
    rows = [
        {"seed": 0, "tag": "t", "in_flight": True, "final_step": 0,
         "test_accuracy": 0.0, "converged": False, "restarts": 0,
         "wall_minutes": 0.0},
        {"seed": 1, "tag": "t", "in_flight": True, "final_step": 0,
         "test_accuracy": 0.0, "converged": False, "restarts": 0,
         "wall_minutes": 0.0},
        {"seed": 0, "tag": "t", "final_step": 500, "test_accuracy": 0.99,
         "converged": True, "restarts": 1, "wall_minutes": 2.5},
        {"seed": 0, "tag": "t", "in_flight": True, "final_step": 0,
         "test_accuracy": 0.0, "converged": False, "restarts": 0,
         "wall_minutes": 0.0},
        {"seed": 2, "tag": "t", "final_step": 300, "test_accuracy": 0.9,
         "converged": False, "restarts": 0, "wall_minutes": 1.0},
        {"seed": 2, "tag": "t", "final_step": 200, "test_accuracy": 0.6,
         "converged": False, "restarts": 0, "wall_minutes": 1.0},
    ]
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    single = summarize_sweep.main([path])
    assert [(r["seed"], r["final_step"], bool(r.get("in_flight")))
            for r in single] == [(0, 500, False), (1, 0, True),
                                 (2, 200, False)]
    out = capsys.readouterr().out
    assert "[in flight at cut]" in out and "converged: 1/3" in out
    union = summarize_sweep.main([path + ":t"])
    assert [r["final_step"] for r in union] == [500, 0, 300]


def metrics_file(folder):
    """A made-up run: evals, a stall restart and its recovery event."""
    os.makedirs(os.path.join(folder, "summary"))
    rows = [{"step": s, "test/accuracy": a} for s, a in
            [(0, 0.3), (2500, 0.61), (5000, 0.62)]]
    rows.append({"step": 5000, "recovery/attempt_ended": 1,
                 "recovery/stalled_accuracy": 0.62,
                 "recovery/next_variant": 0})
    rows += [{"step": s, "train/loss": 1.0} for s in (5000, 5050)]
    rows += [{"step": 2500 * i, "test/accuracy": 0.5 + 0.0021 * i}
             for i in range(3, 420)]
    with open(os.path.join(folder, "summary", "metrics.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return folder


@pytest.mark.parametrize("which", ["made_up", "r3_rescue"])
def test_ledger_is_byte_equal(which, tmp_path, monkeypatch, capsys):
    folder = (metrics_file(str(tmp_path / "run")) if which == "made_up"
              else R3_RUN)
    extra = ["--name", "r", "--note", "a note"]
    monkeypatch.setattr(sys, "argv", [
        "ledger.py", folder, "--out", str(tmp_path / "jax.json"), *extra])
    load_script("ledger").main()
    want_out = capsys.readouterr().out
    rec = ledger.main([folder, "--out", str(tmp_path / "port.json"),
                       *extra])
    assert capsys.readouterr().out == want_out.replace("jax.json",
                                                        "port.json")
    with open(tmp_path / "jax.json", "rb") as a, \
            open(tmp_path / "port.json", "rb") as b:
        assert a.read() == b.read()
    if which == "made_up":
        assert rec["restarts"] == 1
        assert len(rec["eval_trajectory"]) < rec["n_evals"] == 420
        assert rec["recovery_events"] == [{
            "attempt": 1, "stalled_at_step": 5000, "stalled_accuracy": 0.62,
            "next_variant": 0}]


def test_ledger_default_out_is_beside_the_jax_ledgers(tmp_path,
                                                      monkeypatch):
    folder = metrics_file(str(tmp_path / "seed4_x"))
    monkeypatch.chdir(tmp_path)
    ledger.main([folder])
    assert os.path.exists(tmp_path / "torch_runs" / "ledgers" /
                          "seed4_x.json")
