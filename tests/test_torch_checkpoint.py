"""Checkpoints across the two packages: the port's save_checkpoint is read by
the JAX package's load_checkpoint, and the JAX package's checkpoints by the
port's load_checkpoint, params, optimizer leaves (bfloat16 moments
included) and step bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.train.checkpoint import load_checkpoint as jax_load
from air_tpu.train.checkpoint import save_checkpoint as jax_save
from air_tpu.train.state import create_train_state as jax_create
from air_tpu.train.steps import make_train_step as jax_make_train_step
from air_tpu_torch.interop import (opt_state_from_jax, opt_state_to_jax,
                                   params_from_jax, params_to_jax)
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.train.checkpoint import (checkpoint_meta,
                                            latest_checkpoint,
                                            load_checkpoint, save_checkpoint,
                                            sorted_checkpoints)
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import make_train_step
from air_tpu_torch.tree import tree_leaves
from tests.test_torch_model import SMALL
from tests.test_torch_train import LR_SCHEDULE, MAIN_OPT, _images, to_np

CONFIGS = {
    "bf16": dict(MAIN_OPT),
    "fp32": dict(MAIN_OPT, adam_storage_dtype="float32"),
    "bf16-lr-schedule": dict(MAIN_OPT, annealing_schedules=LR_SCHEDULE),
    "background": dict(MAIN_OPT, learn_background=True),
}


def _trained_port_state(kw, steps=2):
    cfg = AIRConfig(**{**SMALL, **kw})
    state = create_train_state(cfg, seed=5, device="cpu")
    step = make_train_step(cfg)
    images, targets = _images(4, SMALL["canvas_size"])
    for _ in range(steps):
        state, _ = step(state, images, targets)
    return cfg, state


def _assert_states_equal(a, b):
    assert (a.step, a.seed) == (b.step, b.seed)
    assert (a.opt_state.count, a.opt_state.schedule_count) == (
        b.opt_state.count, b.opt_state.schedule_count)
    for tree_a, tree_b in ((a.params, b.params), (a.opt_state.mu,
                                                   b.opt_state.mu),
                           (a.opt_state.nu, b.opt_state.nu)):
        for x, y in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", list(CONFIGS))
def test_port_checkpoint_round_trips(case, tmp_path):
    cfg, state = _trained_port_state(CONFIGS[case])
    path = save_checkpoint(str(tmp_path), state, loader_state={"epoch": 1})
    assert os.path.basename(path) == "air-model-2.npz"
    meta = checkpoint_meta(path)
    assert meta["seed"] == 5 and meta["loader_state"] == {"epoch": 1}
    _assert_states_equal(load_checkpoint(path, cfg, device="cpu"), state)


@pytest.mark.parametrize("case", list(CONFIGS))
def test_jax_loads_port_checkpoint(case, tmp_path):
    """The JAX package's load_checkpoint rebuilds the port's state: params in
    its layout, every optimizer leaf (bf16 as bf16) and the step."""
    kw = {**SMALL, **CONFIGS[case]}
    cfg, state = _trained_port_state(CONFIGS[case])
    path = save_checkpoint(str(tmp_path), state)
    jstate = jax_load(path, JaxConfig(**kw))
    assert int(jstate.step) == state.step
    want_params = jax.tree_util.tree_leaves(params_to_jax(state.params))
    got_params = jax.tree_util.tree_leaves(to_np(jstate.params))
    assert len(got_params) == len(want_params)
    for g, w in zip(got_params, want_params):
        np.testing.assert_array_equal(g, w)
    want_opt = opt_state_to_jax(state.opt_state)
    got_opt = jax.tree_util.tree_leaves(jstate.opt_state)
    assert len(got_opt) == len(want_opt)
    for g, w in zip(got_opt, want_opt):
        if w.dtype == torch.bfloat16:
            assert g.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                np.asarray(g).view(np.uint16),
                w.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(g), w.numpy())
    # and the JAX package trains on from it
    images, targets = _images(4, SMALL["canvas_size"])
    _, metrics = jax_make_train_step(JaxConfig(**kw), donate=False)(
        jstate, jnp.asarray(images), jnp.asarray(targets))
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("case", list(CONFIGS))
def test_port_loads_jax_checkpoint(case, tmp_path):
    """A checkpoint the JAX package wrote after two steps (bf16 moments as
    uint16 views) loads into the port bit for bit."""
    kw = {**SMALL, **CONFIGS[case]}
    jcfg = JaxConfig(**kw)
    jstate = jax_create(jcfg, rng=0)
    step = jax_make_train_step(jcfg, donate=False)
    images, targets = _images(4, SMALL["canvas_size"])
    for _ in range(2):
        jstate, _ = step(jstate, jnp.asarray(images), jnp.asarray(targets))
    path = jax_save(str(tmp_path), jstate)
    with np.load(path) as z:
        if kw["adam_storage_dtype"] == "bfloat16":
            assert any(k.endswith(":bf16") for k in z.files)
    state = load_checkpoint(path, AIRConfig(**kw), device="cpu")
    assert state.step == 2 and state.seed == 0
    params = params_from_jax(to_np(jstate.params), "cpu")
    want = opt_state_from_jax(
        to_np(jax.tree_util.tree_leaves(jstate.opt_state)), params, "cpu")
    _assert_states_equal(state, state.replace(params=params, opt_state=want))
    for x, y in zip(tree_leaves(state.params), tree_leaves(params)):
        assert torch.equal(x, y)
    # and the port trains on from it
    _, metrics = make_train_step(AIRConfig(**kw))(state, images, targets)
    assert np.isfinite(float(metrics["loss"]))


def test_params_only_checkpoint_gets_a_fresh_optimizer(tmp_path):
    cfg, state = _trained_port_state(CONFIGS["bf16"], steps=1)
    path = str(tmp_path / "params-only.npz")
    with np.load(save_checkpoint(str(tmp_path), state)) as z:
        np.savez(path, **{k: z[k] for k in z.files
                          if k.startswith("params/") or k == "step"})
    loaded = load_checkpoint(path, cfg, device="cpu")
    assert loaded.opt_state.count == 0
    assert not any(m.any() for m in tree_leaves(loaded.opt_state.mu))


def test_optimizer_structure_must_match_the_config(tmp_path):
    _, state = _trained_port_state(CONFIGS["bf16"], steps=1)
    path = save_checkpoint(str(tmp_path), state)
    with pytest.raises(ValueError):
        load_checkpoint(path, AIRConfig(**{**SMALL, **CONFIGS["fp32"]}),
                        device="cpu")


def test_sidecar_first_and_pruning(tmp_path):
    _, state = _trained_port_state(CONFIGS["bf16"], steps=1)
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), state.replace(step=step),
                        max_to_keep=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["air-model-2.json", "air-model-2.npz",
                     "air-model-3.json", "air-model-3.npz"]
    assert sorted_checkpoints(str(tmp_path)) == [
        str(tmp_path / "air-model-2.npz"), str(tmp_path / "air-model-3.npz")]
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                   "air-model-3.npz")
    assert latest_checkpoint(str(tmp_path / "none")) is None
    with open(tmp_path / "air-model-3.json") as f:
        assert json.load(f)["num_opt_leaves"] == len(
            opt_state_to_jax(state.opt_state))
