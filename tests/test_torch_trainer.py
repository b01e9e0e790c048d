"""The port's trainer against the JAX package's, on the CPU at a small size.

  * policy: is_stalled, cadence_hit, attempt_seed, the restart rotation and
    the results-folder rules agree with the JAX package over a grid of
    cases (exact);
  * evaluate_params: the same chunking, padding and trimming as JAX's with
    the same params and JAX's draws injected (values to 1e-4, the JAX
    package's tolerance for the forward pass; digit counts exact);
  * visualization: the same grid and the same PNG pixels;
  * a tiny Trainer (batch 8): in the host loop it sees the JAX Trainer's
    batches in the JAX Trainer's order; both loops write checkpoints,
    JSONL and a PNG; 6 steps equal 3 steps, a resume and 3 more, bit for
    bit (params, moments and losses); a forced stall restarts with
    attempt_seed and the rotated schedule, as the JAX package does;
  * the driver: unported flags raise, and a tiny run from generated data.
"""

import dataclasses
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from air_tpu.models.air import init_air_params as jax_init
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.train import evaluate as jax_evaluate
from air_tpu.train import trainer as jax_trainer
from air_tpu.train import visualize as jax_visualize
from air_tpu.train.checkpoint import checkpoint_meta as jax_meta
from air_tpu.train.checkpoint import save_checkpoint as jax_save
from air_tpu.train.state import create_train_state as jax_create
from air_tpu.train.steps import make_eval_step as jax_eval_step
from air_tpu_torch import training
from air_tpu_torch.data.loader import TrainLoader
from air_tpu_torch.interop import params_from_jax
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.train import trainer, visualize
from air_tpu_torch.train.checkpoint import (checkpoint_meta, load_checkpoint,
                                            save_checkpoint)
from air_tpu_torch.train.evaluate import evaluate_params
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import make_eval_step
from air_tpu_torch.tree import tree_leaves
from tests.test_torch_model import SMALL, jax_noise

TOL = dict(rtol=1e-4, atol=1e-4)
CS = SMALL["canvas_size"]


def tiny_dataset(n=40, seed=0):
    """Squares of 0-2 'digits' on the small canvas."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, CS, CS), np.float32)
    digits = rng.integers(0, 3, n).astype(np.int32)
    for i in range(n):
        for _ in range(digits[i]):
            x, y = rng.integers(1, CS - 7, 2)
            images[i, y:y + 6, x:x + 6] = 1.0
    return images.reshape(n, -1), digits


# --- policy -----------------------------------------------------------------

HISTORY = [(0, 0.3), (5000, 0.5), (10000, 0.6), (15000, 0.62),
           (20000, 0.625), (25000, 0.63), (30000, 0.64)]
STALL_CASES = [
    # (history, step, acc, detect, stall_acc, window, min_progress, spare)
    (HISTORY, 30000, 0.64, 20000, 0.95, 10000, 0.01, 0.85),
    (HISTORY, 30000, 0.64, 40000, 0.95, 10000, 0.01, 0.85),
    (HISTORY, 30000, 0.64, 20000, 0.95, 0, 0.01, 0.85),
    (HISTORY, 30000, 0.64, 20000, 0.6, 10000, 0.01, 0.85),
    (HISTORY, 30000, 0.9, 20000, 0.95, 10000, 0.01, 0.85),
    (HISTORY, 30000, 0.9, 20000, 0.95, 10000, 0.01, 0.0),
    (HISTORY, 30000, 0.64, 20000, 0.95, 40000, 0.01, 0.85),
    (HISTORY, 30000, 0.64, 20000, 0.95, 10000, 0.2, 0.85),
    (HISTORY[:3] + [(15000, 0.7), (20000, 0.66), (25000, 0.75)],
     25000, 0.75, 20000, 0.95, 10000, 0.01, 0.85),
    ([(0, 0.6), (10000, 0.61), (20000, 0.58), (30000, 0.65)], 30000, 0.6,
     10000, 0.95, 20000, 0.05, 0.0),
    ([], 30000, 0.6, 10000, 0.95, 0, 0.01, 0.0),
    ([], 30000, 0.6, None, 0.95, 0, 0.01, 0.0),
]


@pytest.mark.parametrize("case", range(len(STALL_CASES)))
def test_is_stalled_matches_jax(case):
    args = STALL_CASES[case]
    assert trainer.is_stalled(*args) == jax_trainer.is_stalled(*args)


@pytest.mark.parametrize("every", [None, 0, -5, 1, 3, 50])
def test_cadence_hit_matches_jax(every):
    for step in range(0, 160, 7):
        assert trainer.cadence_hit(step, every) == \
            jax_trainer.cadence_hit(step, every)


@pytest.mark.parametrize("stride", [1009, 1, -7, 0])
def test_attempt_seed_matches_jax(stride):
    for base in (0, 5):
        for attempt in range(4):
            if stride == 0:
                with pytest.raises(ValueError):
                    trainer.attempt_seed(base, attempt, stride)
                continue
            assert trainer.attempt_seed(base, attempt, stride) == \
                jax_trainer.attempt_seed(base, attempt, stride)


def test_trainer_config_and_rotation_match_jax():
    """Every TrainerConfig field of the JAX package, with its default; the
    same built-in rotation; stride 0 refused."""
    ours = {f.name: f.default for f in dataclasses.fields(
        trainer.TrainerConfig)}
    for f in dataclasses.fields(jax_trainer.TrainerConfig):
        assert ours[f.name] == f.default, f.name
    assert trainer.DEFAULT_RESTART_ROTATION == \
        jax_trainer.DEFAULT_RESTART_ROTATION
    with pytest.raises(ValueError):
        trainer.TrainerConfig(attempt_seed_stride=0)


BASE_SCHEDULES = {"z_pres_prior_log_odds": {
    "init": 1e4, "min": 1e-9, "factor": 0.1, "iters": 3000, "log": True,
    "hold": 15000}, "scale_prior_mean": {"init": 1.0, "iters": 10}}


@pytest.mark.parametrize("variant", range(7))
def test_rotation_variants_match_jax(variant):
    rotation = (*jax_trainer.DEFAULT_RESTART_ROTATION,
                {"scale_prior_mean": None})
    got = types.SimpleNamespace(
        tcfg=trainer.TrainerConfig(restart_schedule_rotation=rotation),
        config=AIRConfig(annealing_schedules=BASE_SCHEDULES))
    want = types.SimpleNamespace(
        tcfg=jax_trainer.TrainerConfig(restart_schedule_rotation=rotation),
        config=JaxConfig(annealing_schedules=BASE_SCHEDULES))
    trainer.Trainer._apply_rotation_variant(got, variant)
    jax_trainer.Trainer._apply_rotation_variant(want, variant)
    assert got._variant == want._variant
    assert got.train_config.schedules == want.train_config.schedules
    assert got.config.schedules == BASE_SCHEDULES


@pytest.mark.parametrize("case", ["fresh", "no-checkpoint", "resume",
                                  "no-resume", "overwrite"])
def test_results_folder_rules_match_jax(case, tmp_path):
    """A folder is reused only to resume from its checkpoints, renamed
    otherwise, and wiped only with overwrite_results."""
    kw = {"no-resume": {"resume": False},
          "overwrite": {"overwrite_results": True}}.get(case, {})
    made = {}
    for name, module in (("jax", jax_trainer), ("port", trainer)):
        folder = tmp_path / name / "res"
        if case != "fresh":
            (folder / "models").mkdir(parents=True)
            (folder / "keep.txt").write_text("x")
            if case != "no-checkpoint":
                (folder / "models" / "air-model-5.npz").write_bytes(b"")
        got = module.prepare_results_folder(
            module.TrainerConfig(results_folder=str(folder), **kw))
        made[name] = (os.path.relpath(got, tmp_path / name),
                      (folder / "keep.txt").exists())
    assert made["port"] == made["jax"]


# --- evaluation and visualization ---------------------------------------------

@pytest.mark.parametrize("n,batch", [(7, 3), (6, 3), (2, 4)])
def test_evaluate_params_matches_jax(n, batch):
    jcfg = JaxConfig(**{**SMALL, "st_impl": "xla"})
    cfg = AIRConfig(**SMALL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    images, digits = tiny_dataset(n, seed=1)
    key = jax.random.PRNGKey(3)
    want = jax_evaluate.evaluate_params(
        jax_eval_step(jcfg), jparams, images, digits, batch_size=batch,
        key=key, step=20)
    got = evaluate_params(
        make_eval_step(cfg), params_from_jax(jparams, "cpu"), images, digits,
        batch_size=batch, step=20,
        draws=lambda lo: {"noise": jax_noise(jax.random.fold_in(key, lo),
                                             jcfg, batch)})
    for field in want._fields:
        g, w = np.asarray(getattr(got, field)), np.asarray(
            getattr(want, field))
        assert g.shape == w.shape, field
        if field == "rec_num_digits":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=field, **TOL)
    assert got.rec_num_digits.shape == (n,)


def test_visualization_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    b, t, cs, ws = 3, 3, 20, 8
    original = rng.uniform(size=(b, cs * cs)).astype(np.float32)
    recon = rng.uniform(size=(b, cs * cs)).astype(np.float32)
    s = rng.uniform(1.2, 3.0, (b, t)).astype(np.float32)
    x = rng.uniform(-0.6, 0.6, (b, t, 2)).astype(np.float32)
    st_back = np.zeros((b, t, 2, 3), np.float32)
    st_back[..., 0, 0] = st_back[..., 1, 1] = s
    st_back[..., :, 2] = x
    steps = np.array([0, 2, 3], np.int32)
    want = jax_visualize.visualize_reconstructions(
        original, recon, st_back, steps, cs, ws, zoom=2)
    got = visualize.visualize_reconstructions(
        torch.from_numpy(original), torch.from_numpy(recon),
        torch.from_numpy(st_back), torch.from_numpy(steps), cs, ws, zoom=2)
    assert got.shape == want.shape == (b, 2 * cs, 4 * cs + 4, 3)
    np.testing.assert_array_equal(got, want)
    from PIL import Image
    paths = [visualize.save_grid_png(str(tmp_path / "port.png"), got),
             jax_visualize.save_grid_png(str(tmp_path / "jax.png"), want)]
    port_px, jax_px = (np.asarray(Image.open(p)) for p in paths)
    assert port_px.shape == (b * 2 * cs, 4 * cs + 4, 3)
    np.testing.assert_array_equal(port_px, jax_px)


# --- the tiny Trainer ------------------------------------------------------------

def tiny_configs(tmp_path, name, **kw):
    cfg = AIRConfig(**{**SMALL, "learning_rate": 1e-3,
                       "adam_storage_dtype": "bfloat16"})
    tkw = dict(results_folder=str(tmp_path / name), batch_size=8, seed=3,
               max_iterations=6, num_summaries_every=3, img_summaries_every=3,
               var_summaries_every=3, grad_summaries_every=2,
               save_params_every=3, log_every=1, eval_batch_size=16,
               num_images_to_save=4, source_snapshot=False, tensorboard=True,
               multi_step=2, device="cpu")
    tkw.update(kw)
    return cfg, trainer.TrainerConfig(**tkw)


def run_trainer(tmp_path, name, data, test, **kw):
    cfg, tcfg = tiny_configs(tmp_path, name, **kw)
    tr = trainer.Trainer(cfg, tcfg, data, test)
    return tr, tr.train()


def train_records(tr) -> dict:
    with open(tr.metrics.path) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def test_host_loop_sees_the_jax_trainers_batches(tmp_path):
    """With the same data and seed, the host loop of both trainers hands
    the train step the same batches in the same order (the train step
    itself is replaced by a recorder in both)."""
    data, test = tiny_dataset(20), tiny_dataset(8, seed=9)
    seen = {}
    for name, module, cfg in (
            ("jax", jax_trainer, JaxConfig(**SMALL)),
            ("port", trainer, AIRConfig(**SMALL))):
        kw = dict(results_folder=str(tmp_path / name), batch_size=8, seed=4,
                  max_iterations=7, num_summaries_every=0,
                  grad_summaries_every=0, save_params_every=0, log_every=0,
                  source_snapshot=False)
        if module is trainer:
            kw["device"] = "cpu"
        tr = module.Trainer(cfg, module.TrainerConfig(**kw), data, test)
        batches = []

        def record(state, images, targets, _b=batches):
            _b.append((np.asarray(images).copy(), np.asarray(targets).copy()))
            return state._replace(step=state.step + 1), {}

        tr.train_step = record
        tr.write_eval_summaries = lambda step, with_images: 0.0
        tr.train()
        seen[name] = (batches, tr.loader.state())
    (got, got_state), (want, want_state) = seen["port"], seen["jax"]
    assert len(got) == len(want) == 7
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    assert got_state == want_state


@pytest.mark.parametrize("loop", ["host", "device-data"])
def test_trainer_writes_and_resumes_bit_for_bit(loop, tmp_path):
    """6 steps in one run equal 3 steps, a resume from the step-3
    checkpoint and 3 more: params, Adam moments, step and losses; the run
    writes checkpoints, JSONL, TensorBoard events and PNGs."""
    data, test = tiny_dataset(), tiny_dataset(12, seed=9)
    kw = {"device_data": loop == "device-data"}
    whole, result = run_trainer(tmp_path, "whole", data, test, **kw)
    assert result["step"] == 6 and np.isfinite(result["test_accuracy"])
    # the host loop applies its gradient-summary steps; the device-data
    # loop runs them beside the chunk, unapplied
    applied = whole.calls["grad"] if loop == "host" else 0
    assert whole.calls["train"] + applied == 6 and whole.calls["grad"] > 0
    models = sorted(os.listdir(whole.models_dir))
    for s in (0, 3, 6):
        assert f"air-model-{s}.npz" in models and f"air-model-{s}.json" in \
            models
    summary = os.listdir(whole.summary_dir)
    assert {"metrics.jsonl", "reconstruction_0.png",
            "reconstruction_6.png"} <= set(summary)
    assert any(f.startswith("events.out.tfevents") for f in summary)
    with open(os.path.join(whole.summary_dir, "reconstruction_6.png"),
              "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(whole.metrics.path) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {"test/accuracy", "train/loss", "var/lstm/kernel/norm"} <= keys
    assert any(k.startswith("grad/") for k in keys)

    first, _ = run_trainer(tmp_path, "split", data, test, max_iterations=3,
                           **kw)
    assert first.state.step == 3
    resumed, _ = run_trainer(tmp_path, "split", data, test, **kw)
    assert resumed.folder == first.folder and resumed.state.step == 6
    a, b = whole.state, resumed.state
    assert (a.opt_state.count, a.seed) == (b.opt_state.count, b.seed)
    for ta, tb in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                   (a.opt_state.nu, b.opt_state.nu)):
        for x, y in zip(tree_leaves(ta), tree_leaves(tb)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    losses = train_records(whole)
    split = {**train_records(first), **train_records(resumed)}
    assert len(losses) == 6 and split == losses


def test_chunked_eval_writes_the_summary_keys(tmp_path):
    """A test set larger than eval_batch_size goes through evaluate_params
    in chunks and gives the summaries the one-call path gives."""
    data, test = tiny_dataset(), tiny_dataset(12, seed=9)
    whole, _ = run_trainer(tmp_path, "one", data, test, max_iterations=0)
    chunked, _ = run_trainer(tmp_path, "chunks", data, test,
                             max_iterations=0, eval_batch_size=5)
    assert chunked.calls["eval"] == 3 + 1 and whole.calls["eval"] == 1 + 1
    keys = []
    for tr in (whole, chunked):
        with open(tr.metrics.path) as f:
            rec = [json.loads(line) for line in f][-1]
        assert np.isfinite(rec["test/accuracy"])
        keys.append(sorted(k for k in rec if k.startswith("test/")))
    assert keys[0] == keys[1] and len(keys[0]) > 50


def test_forced_stall_restarts_like_jax(tmp_path):
    """A stall detected at step 3 restarts from attempt_seed's params and
    data order under the first rotated schedule (as the JAX package's
    Trainer does), archives the attempt's checkpoints, persists the
    recovery state, and gives up once the budget is spent."""
    data, test = tiny_dataset(), tiny_dataset(12, seed=9)
    rotation = jax_trainer.DEFAULT_RESTART_ROTATION
    kw = dict(device_data=True, max_iterations=12, stall_detect_step=3,
              stall_window=0, stall_accuracy=1.5, stall_spare_accuracy=0.0,
              max_restarts=1, restart_schedule_rotation=rotation,
              grad_summaries_every=0)
    tr, result = run_trainer(tmp_path, "stall", data, test, **kw)
    assert result["restarts"] == 1 and tr.restarts == 1
    assert result["step"] == 3                 # gave up at the second stall
    new_seed = jax_trainer.attempt_seed(3, 1)
    assert tr.state.seed == trainer.attempt_seed(3, 1) == new_seed
    assert tr.loader.seed == new_seed
    want = types.SimpleNamespace(
        tcfg=jax_trainer.TrainerConfig(restart_schedule_rotation=rotation),
        config=JaxConfig(**SMALL))
    jax_trainer.Trainer._apply_rotation_variant(want, 0)
    assert tr._variant == want._variant == 0
    assert tr.train_config.schedules == want.train_config.schedules
    # the stall is found before the step-3 save: attempt 1 left step 0
    archived = os.listdir(os.path.join(tr.models_dir, "stalled_attempt_1"))
    assert sorted(archived) == ["air-model-0.json", "air-model-0.npz"]
    meta = checkpoint_meta(os.path.join(tr.models_dir, "air-model-3.npz"))
    assert meta["recovery"]["restarts"] == 1
    assert meta["recovery"]["variant"] == 0
    assert meta["loader_state"]["seed"] == new_seed
    # the same attempt again, from the sidecar
    again = trainer.Trainer(*tiny_configs(tmp_path, "stall", **kw), data,
                            test)
    assert again.restarts == 1 and again._variant == 0
    assert again.train_config.schedules == want.train_config.schedules
    assert again.loader.seed == new_seed and again.state.step == 3


def test_checkpoint_sidecars_cross_packages(tmp_path):
    """recovery and loader_state written by either package are read by the
    other; load_checkpoint restores the loader it is given."""
    cfg = AIRConfig(**SMALL)
    rec = {"restarts": 2, "variant": 1, "eval_history": [[0, 0.5]]}
    loader_state = {"epoch": 1, "index": 16, "seed": 7,
                    "perm_backend": "numpy"}
    state = create_train_state(cfg, seed=7, device="cpu")
    path = save_checkpoint(str(tmp_path / "port"), state,
                           loader_state=loader_state, recovery=rec)
    assert jax_meta(path)["recovery"] == rec
    jpath = jax_save(str(tmp_path / "jax"), jax_create(JaxConfig(**SMALL),
                                                       rng=0),
                     loader_state=loader_state, recovery=rec)
    data = tiny_dataset(32)
    for p in (path, jpath):
        assert checkpoint_meta(p)["recovery"] == rec
        ld = TrainLoader(data, 8, seed=0, native=False, prefetch=0)
        load_checkpoint(p, cfg, ld, device="cpu")
        assert (ld.epoch, ld.index, ld.seed) == (1, 16, 7)


# --- the driver -------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--data-parallel", "--pipeline-unroll", "0"], ["--pipeline-unroll", "0"]],
    ids=lambda f: f[0])
def test_unported_flags_raise(flags, tmp_path, monkeypatch):
    """--pipeline-unroll below 1 raises before a results folder is made,
    with --data-parallel too; the unroll itself trains
    (test_trainer_takes_pipeline_unroll)."""
    monkeypatch.chdir(tmp_path)
    data = tiny_dataset(16)
    args = training.build_parser().parse_args(
        ["--device", "cpu", *flags, "--results-folder", "res"])
    cfg, tcfg = training.configs(args)
    with pytest.raises(ValueError, match="pipeline_unroll"):
        trainer.Trainer(cfg, tcfg, data, data)
    assert not os.path.exists(tmp_path / "res")


@pytest.mark.parametrize("loop", ["host", "device-data"])
def test_trainer_takes_pipeline_unroll(loop, tmp_path):
    """pipeline_unroll 2 trains both loops to the losses and params of
    pipeline_unroll 1 (every step one replay whatever U)."""
    data, test = tiny_dataset(), tiny_dataset(12, seed=9)
    runs = {}
    for u in (1, 2):
        tr, result = run_trainer(
            tmp_path, f"u{u}", data, test, max_iterations=3,
            num_summaries_every=0, img_summaries_every=0,
            var_summaries_every=0, grad_summaries_every=0,
            save_params_every=0, tensorboard=False, pipeline_unroll=u,
            device_data=loop == "device-data")
        assert result["step"] == 3
        runs[u] = (train_records(tr), tr.state.params)
    assert len(runs[1][0]) == 3 and runs[2][0] == runs[1][0]
    for a, b in zip(tree_leaves(runs[2][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_driver_defaults_are_the_robust_default_on_the_card():
    args = training.build_parser().parse_args([])
    cfg, tcfg = training.configs(args)
    assert (args.device, cfg.st_impl, tcfg.device) == ("cuda", "inline",
                                                       "cuda")
    assert cfg.cnn and cfg.adam_storage_dtype == "bfloat16"
    assert cfg.schedules["z_pres_prior_log_odds"]["hold"] == 15000
    assert tcfg.stall_detect_step == 60000
    assert tcfg.restart_schedule_rotation == \
        trainer.DEFAULT_RESTART_ROTATION


def test_driver_trains_from_generated_data(tmp_path, monkeypatch):
    """python -m air_tpu_torch.training --device cpu at a tiny size: it
    generates the set from the committed pool and trains through the
    kernels' plain versions."""
    monkeypatch.chdir(tmp_path)
    result = training.main([
        "--device", "cpu", "--synthetic-data", "12", "--steps", "4",
        "--batch-size", "8", "--rnn-units", "16", "--vae-latent", "4",
        "--eval-every", "2", "--img-every", "4", "--save-every", "2",
        "--grad-every", "3", "--log-every", "1", "--device-data",
        "--multi-step", "2", "--results-folder", "res"])
    assert result["step"] == 4 and np.isfinite(result["test_accuracy"])
    for f in ("common.airrec", "test.airrec", "0.airrec", "2.airrec"):
        assert os.path.exists(tmp_path / "multi_mnist_data" / f)
    assert os.path.exists(tmp_path / "res" / "models" / "air-model-4.npz")
    assert os.path.exists(tmp_path / "res" / "source" / "air_tpu_torch" /
                          "training.py")
    shutil.rmtree(tmp_path / "res")


@pytest.mark.parametrize("flags,want", [
    (["--decoder-layout", "stepparallel", "--st-impl", "xla"],
     {"decoder_layout": "stepparallel", "st_impl": "xla"}),
    (["--compute-dtype", "bfloat16"], {"compute_dtype": "bfloat16"}),
    (["--rnn-input-hoist"], {"rnn_input_hoist": True}),
    ([], {"decoder_layout": "scan", "compute_dtype": "float32",
          "rnn_input_hoist": False})], ids=lambda f: str(f))
def test_training_cli_passes_the_layout_flags(flags, want):
    """The three flags reach the model config as the root training.py
    passes them (training.py:255-264); without them the config's own
    defaults stand."""
    args = training.build_parser().parse_args(flags)
    cfg, _ = training.configs(args)
    assert {k: getattr(cfg, k) for k in want} == want


@pytest.mark.parametrize("flags", [
    ["--decoder-layout", "stepparallel", "--st-impl", "xla",
     "--rnn-input-hoist"],
    ["--compute-dtype", "bfloat16", "--rnn-input-hoist"],
    ["--compute-dtype", "bfloat16", "--decoder-layout", "stepparallel",
     "--st-impl", "xla"]], ids=lambda f: " ".join(f))
def test_training_cli_trains_through_the_layouts(tmp_path, monkeypatch, flags):
    """python -m air_tpu_torch.training with the layout flags, both loops'
    device-data variant at a tiny size on the CPU: finite losses, a
    checkpoint, float32 master params."""
    monkeypatch.chdir(tmp_path)
    result = training.main([
        "--device", "cpu", "--synthetic-data", "12", "--steps", "3",
        "--batch-size", "8", "--rnn-units", "16", "--vae-latent", "4",
        "--eval-every", "3", "--img-every", "3", "--save-every", "3",
        "--grad-every", "3", "--log-every", "1", "--device-data",
        "--multi-step", "3", "--results-folder", "res", *flags])
    assert result["step"] == 3 and np.isfinite(result["test_accuracy"])
    ckpt = tmp_path / "res" / "models" / "air-model-3.npz"
    with np.load(ckpt) as z:
        assert all(z[k].dtype == np.float32 for k in z.files
                   if k.startswith("params/"))
    with open(tmp_path / "res" / "summary" / "metrics.jsonl") as f:
        losses = [r["train/loss"] for r in map(json.loads, f)
                  if "train/loss" in r]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
