"""The port's sequential seed sweep (air_tpu_torch.seed_sweep_single)
against the JAX package's scripts/seed_sweep.py: with the trainer replaced
by a stub that records its configs and returns a fixed result, both build
the same model and trainer configs, tags, folders and results.jsonl rows
for each flag set. Then one tiny real run of the port on the CPU."""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import air_tpu.train.trainer as jax_trainer
import air_tpu_torch.train.trainer as trainer
from air_tpu_torch import seed_sweep_single
from air_tpu_torch.models import config as torch_config
from air_tpu_torch.training import synthesize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT = {"step": 12345, "test_accuracy": 0.9815, "restarts": 2}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("sweep_single_data"))
    synthesize(folder, 12)
    return folder


def recording_trainer(calls):
    class Stub:
        def __init__(self, cfg, tcfg, train_data, test_data):
            calls.append((cfg, tcfg, train_data, len(test_data[0])))

        def train(self):
            return dict(RESULT)

    return Stub


def plain(cfg, skip=()):
    """A config's fields as plain values (schedules thawed)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name not in skip}
    if "annealing_schedules" in out:
        out["annealing_schedules"] = cfg.schedules
    return out


FLAGS = [
    [],
    ["--cnn"],
    ["--cnn", "--temp-anneal"],
    ["--temp-anneal", "--hold", "6000"],
    ["--cnn", "--scale-prior-curriculum"],
    ["--cnn", "--temp-anneal", "--scale-prior-curriculum", "--hold", "0"],
    ["--cnn", "--stall-restart", "60000", "--max-restarts", "2",
     "--attempt-stride", "7"],
    ["--cnn", "--rotate", "0", "--stall-restart", "5000"],
    ["--adam-dtype", "bfloat16", "--unroll", "2", "--tag", "mine",
     "--max-iters", "900", "--stop-acc", "0.5", "--eval-every", "100"],
]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "defaults")
def test_configs_rows_and_folders_match_jax(flags, data, tmp_path,
                                            monkeypatch, capsys):
    seed = 3
    common = [str(seed), "--data", data]
    jax_calls, calls = [], []
    monkeypatch.setattr(jax_trainer, "Trainer", recording_trainer(jax_calls))
    monkeypatch.setattr(trainer, "Trainer", recording_trainer(calls))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["seed_sweep.py", *common, "--out",
                                      jax_out, *flags])
    load_script("seed_sweep").main()
    jax_printed = capsys.readouterr().out
    rec = seed_sweep_single.main([*common, "--out", out, *flags,
                                  "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.replace(out, jax_out) == jax_printed

    (jcfg, jtcfg, jpath, jn), = jax_calls
    (cfg, tcfg, path, n), = calls
    assert (path, n) == (jpath, jn)
    # the JAX script takes the package's default st_impl; the port's
    # defaults to the kernels (--st-impl)
    want = plain(jcfg, skip=("st_impl",))
    got = plain(cfg)
    assert got["st_impl"] == "inline"
    assert {k: got[k] for k in want} == want
    jt = plain(jtcfg)
    t = plain(tcfg)
    assert t["device"] == "cpu"
    assert t.pop("results_folder") == os.path.join(
        out, os.path.basename(jt.pop("results_folder")))
    assert {k: t[k] for k in jt} == jt

    def rows(folder):
        with open(os.path.join(folder, "results.jsonl")) as f:
            return [json.loads(line) for line in f]

    assert rows(out) == rows(jax_out)
    assert rows(out)[0]["in_flight"] and rows(out)[1] == rec
    assert rec["final_step"] == RESULT["step"]
    assert rec["restarts"] == RESULT["restarts"]


def test_defaults_match_jax_but_paths():
    """Every flag of the JAX script with its default; the data and out
    folders lie beside the run, and the port adds --device, --st-impl and
    --synthetic-data."""
    import argparse
    parsers = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        parsers.append(self)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            load_script("seed_sweep").main()
    finally:
        argparse.ArgumentParser.parse_args = real
    jax_actions = {a.dest: a.default for a in parsers[0]._actions}
    actions = {a.dest: a.default
               for a in seed_sweep_single.build_parser()._actions}
    assert actions.pop("device") == "cuda"
    assert actions.pop("st_impl") == "inline"
    assert actions.pop("synthetic_data") == 0
    assert actions.pop("data") == "multi_mnist_data"
    assert actions.pop("out") == "seq_sweep"
    jax_actions.pop("data"), jax_actions.pop("out")
    assert actions == jax_actions


@pytest.fixture
def one_thread():
    """The small eager ops on one thread, as the suite's workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tiny_real_run(data, tmp_path, monkeypatch, one_thread):
    """The CLI end to end on the CPU at LSTM 16, batch 8, with the
    temperature anneal: the trainer's evals land in its folder and the
    ledger's rows say what it returned."""
    monkeypatch.setattr(
        torch_config, "DEFAULT_TRAINING_CONFIG",
        torch_config.DEFAULT_TRAINING_CONFIG.replace(
            rnn_units=16, vae_latent_dimensions=6,
            vae_recognition_units=(32, 16), vae_generative_units=(16, 32)))
    real = seed_sweep_single.trainer_config

    def small(args, folder):
        return dataclasses.replace(real(args, folder), batch_size=8,
                                   multi_step=3, eval_batch_size=8)

    monkeypatch.setattr(seed_sweep_single, "trainer_config", small)
    out = str(tmp_path / "out")
    rec = seed_sweep_single.main(["1", "--cnn", "--temp-anneal", "--data",
                                  data, "--out", out, "--max-iters", "6",
                                  "--eval-every", "3", "--device", "cpu"])
    assert rec["tag"] == "hold15000_cnn_temp"
    assert rec["final_step"] == 6 and rec["restarts"] == 0
    assert 0.0 <= rec["test_accuracy"] <= 1.0
    with open(os.path.join(out, "results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["in_flight"] and rows[1] == rec
    with open(os.path.join(out, "seed1_hold15000_cnn_temp", "summary",
                           "metrics.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    steps = [r["step"] for r in evals if "test/accuracy" in r]
    assert steps == [0, 3, 6]
    assert np.isclose([r["test/accuracy"] for r in evals
                       if "test/accuracy" in r][-1], rec["test_accuracy"])
