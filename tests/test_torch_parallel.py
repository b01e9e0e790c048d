"""Multi-device training of the port (air_tpu_torch.parallel) against the
JAX package's air_tpu/parallel and the port's single-card step, on the CPU:
ranks spawned by air_tpu_torch.parallel.launch over gloo, each world once
per module (tests/torch_parallel_ranks.py runs every case of a world in
its ranks), every launch under a time limit.

  * the mesh's shapes and ValueError, the set of sharded leaves at model
    axis 2 (JAX's leaf_sharding's, exactly), the captured step's refusal
    of a model axis, and a kernel of a width that is neither whole nor a
    column slice raising, without processes;
  * a world of one: the single-card step's bits, eager and captured;
  * data axis 2 on SMALL: one step against JAX's make_parallel_train_step
    over make_mesh(2) from the same params with its global draws (loss to
    rtol 1e-5, params to 1e-4: tests/test_parallel.py's bars), the eval
    step against the single-card eval (1e-5), the captured multi-step (K =
    3) against make_multi_step on the same global draws, the trainer's two
    loops (6 steps, a resume from step 3 bit-exact, rank 0 alone writing),
    and the driver's --data-parallel;
  * data 2 x model 2: one step against JAX's single-device step with the
    rnn input hoist off and on: the loss, the params, the gradients before
    and after the clip (the shards gathered), their norm and each leaf's
    statistics, so the model axis's hand-written backward is held by size
    and not only by the sign that Adam's first step follows; the shards'
    shapes checked.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.models.air import init_air_params as jax_init
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_DEFAULT
from air_tpu.parallel.mesh import leaf_sharding as jax_leaf_sharding
from air_tpu.parallel.mesh import make_mesh as jax_make_mesh
from air_tpu.parallel.mesh import replicated
from air_tpu.parallel.train_parallel import make_parallel_train_step as \
    jax_parallel_step
from air_tpu.parallel.train_parallel import shard_batch as jax_shard_batch
from air_tpu.train.fast_pipeline import make_multi_step as \
    jax_make_multi_step
from air_tpu.train.state import create_train_state as jax_create
from air_tpu.train.steps import make_train_step as jax_make_train_step
from air_tpu_torch import training
from air_tpu_torch.interop import params_from_jax
from air_tpu_torch.models.config import AIRConfig, DEFAULT_TRAINING_CONFIG
from air_tpu_torch.nn.layers import dense_apply
from air_tpu_torch.parallel.collectives import model_axis
from air_tpu_torch.parallel.launch import launch
from air_tpu_torch.parallel.mesh import (Mesh, leaf_sharding, make_mesh,
                                         param_sharding, shard_batch)
from air_tpu_torch.parallel.train_parallel import make_parallel_train_step
from air_tpu_torch.train.fast_pipeline import make_parallel_multi_step
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.tree import path_name, tree_leaves, tree_leaves_with_path
from tests import torch_parallel_ranks as ranks
from tests.test_torch_model import SMALL, jax_noise
from tests.test_torch_train import MAIN_OPT, to_np

KW = {**SMALL, **MAIN_OPT}
B = 8
LAUNCH_SECONDS = 600


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, SMALL["canvas_size"] ** 2)).astype(
        np.float32)
    return images, (np.arange(B) % 3).astype(np.int32)


def _dataset(n=40, seed=0):
    """Squares of 0-2 'digits' on the small canvas."""
    cs = SMALL["canvas_size"]
    rng = np.random.default_rng(seed)
    images = np.zeros((n, cs, cs), np.float32)
    digits = rng.integers(0, 3, n).astype(np.int32)
    for i in range(n):
        for _ in range(digits[i]):
            x, y = rng.integers(1, cs - 7, 2)
            images[i, y:y + 6, x:x + 6] = 1.0
    return images.reshape(n, -1), digits


def _jax_state(jcfg, rng=0):
    jstate = jax_create(jcfg, rng=rng)
    return jstate, (to_np(jstate.params),
                    to_np(jax.tree_util.tree_leaves(jstate.opt_state)))


def _global_draws(jcfg, jstate):
    key = jax.random.fold_in(jstate.key, int(jstate.step))
    return {k: v.numpy() for k, v in jax_noise(key, jcfg, B).items()}


def _max_diff(got: dict, want, relative: bool = False) -> float:
    """The largest |got - want| over two trees of the JAX package's layout;
    ``relative``: over each leaf's max(1, max |want|), as
    tests/test_torch_train_step.py holds gradients."""
    want = params_from_jax(to_np(want), "cpu")
    got = params_from_jax(got, "cpu")
    return max(float((a - b).abs().max())
               / (max(1.0, float(b.abs().max())) if relative else 1.0)
               for (_, a), (_, b) in zip(tree_leaves_with_path(got),
                                         tree_leaves_with_path(want)))


# --- without processes ------------------------------------------------------

def test_mesh_shapes():
    for n, m in ((8, 1), (8, 2), (4, 4)):
        assert make_mesh(n, model_axis=m).shape == dict(
            jax_make_mesh(n, model_axis=m).shape)
    assert make_mesh(8, model_axis=2).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        jax_make_mesh(6, model_axis=4)
    with pytest.raises(ValueError):
        make_mesh(6, model_axis=4)


@pytest.mark.parametrize("jcfg,cfg", [
    (JaxConfig(**KW), AIRConfig(**KW)),
    (JAX_DEFAULT.replace(cnn=True),
     DEFAULT_TRAINING_CONFIG.replace(cnn=True))],
    ids=["small", "robust_default"])
def test_sharded_leaves_are_jax_s(jcfg, cfg):
    """At model axis 2 the port shards exactly the leaves JAX's
    leaf_sharding column-shards, with the port's layout of them."""
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    jmesh = jax_make_mesh(2, model_axis=2)
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)
            if "model" in str(jax_leaf_sharding(jmesh, leaf).spec)}
    mesh = make_mesh(2, model_axis=2)
    leaves = tree_leaves_with_path(params_from_jax(to_np(params), "cpu"))
    got = {path_name(p) for p, t in leaves if leaf_sharding(mesh, t)}
    assert got == want and "lstm/kernel" in got
    assert {path_name(p) for (p, _), s in zip(
        leaves, param_sharding(mesh, cfg)) if s} == want


def test_batch_must_divide_by_the_data_axis():
    cfg = AIRConfig(**KW)
    mesh = make_mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        make_parallel_multi_step(cfg, ranks.K, 5, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, np.zeros((5, 400), np.float32), np.zeros(5))
    with pytest.raises(ValueError, match="pipeline_unroll"):
        make_parallel_multi_step(cfg, ranks.K, B, mesh, pipeline_unroll=0)
    # a mesh made without a process group has no collectives
    step = make_parallel_train_step(cfg, mesh)
    with pytest.raises(RuntimeError, match="no process groups"):
        step(create_train_state(cfg, device="cpu"),
             *shard_batch(mesh, *_batch()))


def test_multi_step_is_data_parallel_only():
    """The captured step takes no model axis (the JAX package's replicates
    its state); make_parallel_train_step is the model axis's step."""
    with pytest.raises(ValueError, match="data-parallel only"):
        make_parallel_multi_step(AIRConfig(**KW), ranks.K, B,
                                 make_mesh(4, model_axis=2))


def test_a_kernel_of_another_width_is_no_shard():
    """Under a model axis a kernel narrower than its bias is this rank's
    column slice only at exactly out / model columns; any other width
    raises before a collective, as it does outside a model axis."""
    mesh = Mesh(1, 2, model_group="unused")   # raises before any collective
    x = torch.ones((2, 3))
    params = {"w": torch.ones((3, 3)), "b": torch.zeros(8)}
    with model_axis(mesh):
        with pytest.raises(ValueError, match="neither whole nor"):
            dense_apply(params, x)
    with pytest.raises(RuntimeError, match="outside a model axis"):
        dense_apply(params, x)
    whole = {"w": torch.ones((3, 8)), "b": torch.zeros(8)}
    with model_axis(mesh):
        assert torch.equal(dense_apply(whole, x), x @ whole["w"])


# --- a world of one -------------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    images, digits = _batch(1)
    return launch(ranks.world1, "gloo", ["cpu"],
                  (AIRConfig(**KW), images, digits, _dataset(seed=1)),
                  timeout=LAUNCH_SECONDS)[0]


def test_world1_is_the_single_card_step(world1):
    assert world1["step"]
    single, parallel = world1["multi_step"]
    assert single == parallel and single[3] == ranks.K


# --- data axis 2 -----------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jcfg = JaxConfig(**KW)
    jstate, jax_state = _jax_state(jcfg)
    images, digits = _batch()
    jmesh = jax_make_mesh(2)
    jnew, jmetrics = jax_parallel_step(jcfg, jmesh, donate=False)(
        jax.device_put(jstate, replicated(jmesh)),
        *jax_shard_batch(jmesh, images, digits))
    # JAX's unrolled K-step scan, from batch 1 of a permutation, with its
    # per-step draws
    data = _dataset()
    perm = np.random.default_rng(4).permutation(len(data[0]))
    draws = [{k: v.numpy() for k, v in jax_noise(
        jax.random.fold_in(jstate.key, i), jcfg, B).items()}
        for i in range(ranks.K)]
    unrolled = {}
    for u in ranks.UNROLLS:
        jnew_u, jm_u = jax_make_multi_step(jcfg, ranks.K, B, donate=False,
                                           pipeline_unroll=u)(
            jstate, jnp.asarray(data[0]), jnp.asarray(data[1]),
            jnp.asarray(perm, jnp.int32), jnp.asarray(1, jnp.int32))
        unrolled[u] = (jnew_u.params, np.asarray(jm_u["loss"]))
    results = launch(ranks.world2, "gloo", ["cpu"] * 2,
                     (AIRConfig(**KW), jax_state, images, digits,
                      _global_draws(jcfg, jstate), data,
                      str(tmp_path_factory.mktemp("world2")),
                      (perm, draws)),
                     timeout=LAUNCH_SECONDS)
    return jnew, jmetrics, results, unrolled


def test_world2_step_matches_jax_parallel_step(world2):
    jnew, jmetrics, results, _ = world2
    for out in results:
        assert out["shape"] == {"data": 2, "model": 1}
        params, metrics = out["step"]
        np.testing.assert_allclose(metrics["loss"], float(jmetrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(metrics["accuracy"],
                                   float(jmetrics["accuracy"]), rtol=1e-6)
        assert _max_diff(params, jnew.params) < 1e-4
    # the ranks hold one replica
    a, b = (params_from_jax(out["step"][0], "cpu") for out in results)
    for (_, x), (_, y) in zip(tree_leaves_with_path(a),
                              tree_leaves_with_path(b)):
        assert torch.equal(x, y)


def test_world2_eval_matches_single_card(world2):
    for out in world2[2]:
        got, want = out["eval"]
        for field, w in want.items():
            if field == "rec_num_digits":
                np.testing.assert_array_equal(got[field], w)
            else:
                np.testing.assert_allclose(got[field], w, rtol=1e-5,
                                           atol=1e-5, err_msg=field)


def test_world2_multi_step_matches_multi_step(world2):
    for out in world2[2]:
        (single, s_loss, s_step), (par, p_loss, p_step) = out["multi_step"]
        assert s_step == p_step == ranks.K
        np.testing.assert_allclose(p_loss, s_loss, rtol=1e-5)
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(par, single)) < 1e-4


@pytest.mark.parametrize("unroll", ranks.UNROLLS)
def test_world2_unrolled_multi_step_matches_jax(world2, unroll):
    """K steps of the data-parallel step at pipeline_unroll U (U = 2 leaves
    JAX's scan a remainder of one) from JAX's state with its draws, against JAX's
    unrolled single-device scan (losses to 1e-4 relative, params to 1e-5),
    and bit-equal to the data-parallel step at U = 1."""
    unrolled = world2[3]
    for out in world2[2]:
        runs = out["unrolled"]
        params, loss = runs[unroll]
        assert loss == runs[1][1]
        assert all(np.array_equal(a, b) for a, b in zip(params, runs[1][0]))
        jparams, jloss = unrolled[unroll]
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        for a, b in zip(params, tree_leaves(params_from_jax(
                to_np(jparams), "cpu"))):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_world2_trainer(world2, loop):
    """Both ranks train in step (one replica), only rank 0 writes, and a
    resume from the step-3 checkpoint repeats steps 4-6 bit for bit."""
    runs = [out["trainer"][loop] for out in world2[2]]
    zero, one = runs
    assert zero["folders"] == one["folders"]
    assert zero["rank0"] == (True, True) and one["rank0"] == (False, False)
    for run in runs:
        assert run["params"][0] == run["params"][1] == zero["params"][0]
        assert run["moments"][0] == run["moments"][1]
    first, again = zero["records"]
    assert all(len(recs) == 1 for recs in first.values())
    assert len(first) == 6 and 0 < len(again) < 6
    for step, recs in again.items():
        assert len(recs) == 1
        assert recs[0]["train/loss"] == first[step][0]["train/loss"]
    assert {"air-model-0.npz", "air-model-3.npz",
            "air-model-6.npz"} <= set(zero["files"])


def test_driver_data_parallel(tmp_path, monkeypatch):
    """python -m air_tpu_torch.training --data-parallel --n-devices 2
    --device cpu: two ranks over gloo, from a generated set, with the
    unroll flag (one step per pair of replays around the all-reduce)."""
    monkeypatch.chdir(tmp_path)
    result = training.main([
        "--device", "cpu", "--data-parallel", "--n-devices", "2",
        "--synthetic-data", "6", "--steps", "2", "--batch-size", "4",
        "--rnn-units", "8", "--no-cnn", "--eval-every", "2",
        "--img-every", "100", "--grad-every", "2", "--save-every", "2",
        "--multi-step", "2", "--device-data", "-r", str(tmp_path / "res"),
        "--stall-restart-step", "0", "--pipeline-unroll", "2"])
    assert result["step"] == 2 and np.isfinite(result["test_accuracy"])
    assert sorted(os.listdir(tmp_path / "res" / "models")) == [
        "air-model-0.json", "air-model-0.npz", "air-model-2.json",
        "air-model-2.npz"]


# --- data 2 x model 2 ------------------------------------------------------

@pytest.fixture(scope="module")
def world4():
    images, digits = _batch(2)
    cfgs, jax_states, want = [], [], []
    for hoist in (False, True):
        jcfg = JaxConfig(**KW, rnn_input_hoist=hoist)
        jstate, jax_state = _jax_state(jcfg)
        want.append(jax_make_train_step(jcfg, donate=False,
                                        with_grad_stats=True)(
            jstate, jnp.asarray(images), jnp.asarray(digits)))
        cfgs.append(AIRConfig(**KW, rnn_input_hoist=hoist))
        jax_states.append(jax_state)
    noise = _global_draws(JaxConfig(**KW), jstate)
    results = launch(ranks.world4, "gloo", ["cpu"] * 4,
                     (cfgs, jax_states, images, digits, noise),
                     timeout=LAUNCH_SECONDS)
    return want, results


@pytest.mark.parametrize("hoist", [False, True], ids=["plain", "hoist"])
def test_world4_data_model_matches_single_device(world4, hoist):
    want, results = world4
    jnew, jmetrics = want[hoist]
    units = SMALL["rnn_units"]
    for out in results:
        assert out["shape"] == {"data": 2, "model": 2}
        params, metrics, shapes, moments, grads, stats = out["steps"][hoist]
        np.testing.assert_allclose(metrics["loss"], float(jmetrics["loss"]),
                                   rtol=1e-5)
        assert _max_diff(params, jnew.params) < 1e-4
        # the model axis's backward: the gathered shards' gradients before
        # and after the clip (9.8e-6 and 1.7e-6 measured), their norm
        # (2.8e-6 relative) and each leaf's statistics (2.2e-5)
        for kind in ("original", "applied"):
            assert _max_diff(grads[kind], jmetrics["grad_tensors"][kind],
                             relative=True) < 5e-5, kind
        np.testing.assert_allclose(metrics["grad_norm"],
                                   float(jmetrics["grad_norm"]), rtol=1e-5)
        assert set(stats) == set(jmetrics["grad_stats"])
        for name, v in stats.items():
            np.testing.assert_allclose(
                v, float(jmetrics["grad_stats"][name]), rtol=1e-4,
                atol=1e-6, err_msg=name)
        in_dim = AIRConfig(**KW).rnn_input_dim + units
        assert shapes["lstm/kernel"] == moments["lstm/kernel"] == (
            in_dim, 4 * units // 2)
        rec = SMALL["vae_recognition_units"]
        gen = SMALL["vae_generative_units"]
        assert shapes["vae/rec/0/w"] == (SMALL["windows_size"] ** 2,
                                         rec[0] // 2)
        assert shapes["vae/gen/1/w"] == moments["vae/gen/1/w"] == (
            gen[0], gen[1] // 2)
        assert shapes["lstm/bias"] == (4 * units,)
