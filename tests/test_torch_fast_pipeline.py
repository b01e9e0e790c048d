"""The port's captured train step (air_tpu_torch.train.fast_pipeline) on the
CPU, where its slot-based body runs eagerly: against the JAX package's
make_multi_step, against the port's eager train step, and in the trainer;
and the port's profiling utilities (air_tpu_torch.utils.profiling).

Tolerances: against JAX, the losses 1e-4 relative, as one train step
(tests/test_torch_train_step.py), and the params after K steps 1e-5
absolute. Against the port's eager step: bit for bit, the slots hold the
values the eager step computes and the body is the same.

The gpu-marked tests, the ones of this file that run where JAX is not
installed, capture the step on the card (at SMALL, and at BASELINE config
4's widths) and hold its replays to the eager step's bits:

    python -m pytest --noconftest -m gpu tests/test_torch_fast_pipeline.py
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from air_tpu_torch.data.loader import DeviceDataPipeline
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.parallel.mesh import make_mesh
from air_tpu_torch.train import fast_pipeline, trainer
from air_tpu_torch.train.fast_pipeline import (make_multi_step,
                                               make_parallel_multi_step)
from air_tpu_torch.train.multi_seed import make_replica_body
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import make_step_body, make_train_step
from air_tpu_torch.tree import tree_leaves, tree_map
from air_tpu_torch.utils import profiling

try:    # the machine with the card has no JAX; only the gpu test runs there
    import jax
    import jax.numpy as jnp

    from air_tpu.models.config import AIRConfig as JaxConfig
    from air_tpu.train.fast_pipeline import (
        make_multi_step as jax_make_multi_step)
    from air_tpu.train.state import create_train_state as jax_create
    from air_tpu.utils import profiling as jax_profiling
    from air_tpu_torch.interop import opt_state_from_jax, params_from_jax
    from tests.test_torch_model import SMALL, jax_noise
    from tests.test_torch_train import LR_SCHEDULE, MAIN_OPT, to_np
    from tests.test_torch_trainer import tiny_dataset
except ImportError:
    jax = None
    SMALL = dict(max_steps=2, max_digits=2, rnn_units=32, canvas_size=20,
                 windows_size=8, vae_latent_dimensions=6,
                 vae_recognition_units=(32, 16),
                 vae_generative_units=(16, 32), scale_hidden_units=8,
                 shift_hidden_units=8, z_pres_hidden_units=8, cnn=True,
                 st_impl="inline")

N, B, K = 24, 4, 3
K_U = 3          # steps of the unrolled run: JAX's scan has a remainder
ANNEALED = {"z_pres_prior_log_odds": {"init": 100.0, "min": 1e-3,
                                      "factor": 0.5, "iters": 3,
                                      "log": True}}


def _data(seed=11, n=N, cs=20):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, cs * cs)).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(
        (np.arange(n) % 3).astype(np.int32))


def _trees(state):
    return (state.params, state.opt_state.mu, state.opt_state.nu)


def assert_same_state(got, want):
    """Params and moments bit for bit, and the clocks."""
    assert (got.step, got.seed, got.opt_state.count,
            got.opt_state.schedule_count) == (
        want.step, want.seed, want.opt_state.count,
        want.opt_state.schedule_count)
    for a, b in zip(tree_leaves(_trees(got)), tree_leaves(_trees(want))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def clone_state(state):
    return state._replace(
        params=tree_map(torch.clone, state.params),
        opt_state=state.opt_state._replace(
            mu=tree_map(torch.clone, state.opt_state.mu),
            nu=tree_map(torch.clone, state.opt_state.nu)))


def eager_steps(cfg, state, images, digits, perm, start, k, batch=B,
                **kw):
    """k eager train steps on batches start.. of perm, gathered (and
    clamped) as the device-data loop gathers them: (state, [k] metrics)."""
    step = make_train_step(cfg, **kw)
    metrics = []
    for i in range(k):
        lo = min((start + i) * batch, len(images) - batch)
        rows = perm[lo:lo + batch]
        state, m = step(state, images[rows], digits[rows])
        metrics.append(m)
    return state, {name: torch.stack([m[name] for m in metrics])
                   for name in metrics[0]}


def assert_same_metrics(got, want):
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


# -------------------- against JAX ------------------------------------------
@pytest.mark.skipif(jax is None, reason="needs JAX")
def test_make_multi_step_matches_jax():
    """K = 3 steps from batch 1 of a permutation, from JAX's state and with
    JAX's per-step draws: losses to 1e-4 relative, params to 1e-5."""
    kw = {**SMALL, **MAIN_OPT, "annealing_schedules": ANNEALED}
    jcfg, cfg = JaxConfig(**kw), AIRConfig(**kw)
    jstate = jax_create(jcfg, rng=3)
    images, digits = _data(4, N, cfg.canvas_size)
    perm = np.random.default_rng(5).permutation(N)
    jnew, jm = jax_make_multi_step(jcfg, K, B, donate=False)(
        jstate, jnp.asarray(images.numpy()), jnp.asarray(digits.numpy()),
        jnp.asarray(perm, jnp.int32), jnp.asarray(1, jnp.int32))

    params = params_from_jax(to_np(jstate.params), "cpu")
    state = create_train_state(cfg, params=params, device="cpu")
    state = state.replace(opt_state=opt_state_from_jax(
        to_np(jax.tree_util.tree_leaves(jstate.opt_state)), params, "cpu"))
    noise = [jax_noise(jax.random.fold_in(jstate.key, i), jcfg, B)
             for i in range(K)]
    new, m = make_multi_step(cfg, K, B)(
        state, images, digits, torch.from_numpy(perm), 1, noise=noise)
    for name in ("loss", "reconstruction_loss", "kl_loss", "accuracy",
                 "z_pres_prior_log_odds"):
        assert tuple(m[name].shape) == (K,)
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-4, err_msg=name)
    for a, b in zip(tree_leaves(new.params),
                    tree_leaves(params_from_jax(to_np(jnew.params), "cpu"))):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5)
    assert new.step == int(jnew.step) == K


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("unroll", [2])
def test_unrolled_multi_step_matches_jax(unroll):
    """K_U = 3 steps at pipeline_unroll U (JAX's scan: a remainder of one
    step) from batch 1, from JAX's state with JAX's draws, against
    JAX's unrolled scan: losses to 1e-4 relative, params to 1e-5; and
    bit-equal to the port's U = 1."""
    kw = {**SMALL, **MAIN_OPT, "annealing_schedules": ANNEALED}
    jcfg, cfg = JaxConfig(**kw), AIRConfig(**kw)
    jstate = jax_create(jcfg, rng=3)
    images, digits = _data(4, N, cfg.canvas_size)
    perm = np.random.default_rng(5).permutation(N)
    jnew, jm = jax_make_multi_step(jcfg, K_U, B, donate=False,
                                   pipeline_unroll=unroll)(
        jstate, jnp.asarray(images.numpy()), jnp.asarray(digits.numpy()),
        jnp.asarray(perm, jnp.int32), jnp.asarray(1, jnp.int32))

    params = params_from_jax(to_np(jstate.params), "cpu")
    state = create_train_state(cfg, params=params, device="cpu")
    state = state.replace(opt_state=opt_state_from_jax(
        to_np(jax.tree_util.tree_leaves(jstate.opt_state)), params, "cpu"))
    noise = [jax_noise(jax.random.fold_in(jstate.key, i), jcfg, B)
             for i in range(K_U)]
    runs = {}
    for u in (1, unroll):
        new, m = make_multi_step(cfg, K_U, B, pipeline_unroll=u)(
            state, images, digits, torch.from_numpy(perm), 1, noise=noise)
        runs[u] = (clone_state(new), m)
    new, m = runs[unroll]
    assert_same_state(new, runs[1][0])
    assert_same_metrics(m, runs[1][1])
    for name in ("loss", "reconstruction_loss", "kl_loss", "accuracy",
                 "z_pres_prior_log_odds"):
        assert tuple(m[name].shape) == (K_U,)
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-4, err_msg=name)
    for a, b in zip(tree_leaves(new.params),
                    tree_leaves(params_from_jax(to_np(jnew.params), "cpu"))):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5)
    assert new.step == int(jnew.step) == K_U


# -------------------- against the eager step -------------------------------
@pytest.mark.parametrize("case", ["plain", "annealed-bg-lr"])
def test_slot_body_is_the_eager_step(case):
    """K steps of the slot-based body, in two calls (a chunk of 2 from
    batch 2, then one of 1), bit-equal to K eager train_step calls: with
    the annealed prior, a learning-rate schedule and the background
    composite every scalar slot is in use."""
    kw, step_kw = {**SMALL, **MAIN_OPT}, {}
    if case != "plain":
        kw.update(learn_background=True,
                  annealing_schedules={**ANNEALED, **LR_SCHEDULE})
        step_kw = dict(
            bg_image=np.random.default_rng(7).uniform(size=400).astype(
                np.float32),
            bg_schedule={"target": 0.6, "start": 1, "ramp": 3})
    cfg = AIRConfig(**kw)
    images, digits = _data(3, N, cfg.canvas_size)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(N))
    state0 = create_train_state(cfg, seed=2, device="cpu").replace(step=4)
    multi = make_multi_step(cfg, 2, B, **step_kw)
    s1, m1 = multi(state0, images, digits, perm, 2)
    s2, m2 = multi(s1, images, digits, perm, 4, num_steps=1)
    want, wm = eager_steps(cfg, state0, images, digits, perm, 2, K,
                           **step_kw)
    assert_same_state(s2, want)
    assert_same_metrics({k: torch.cat([m1[k], m2[k]]) for k in m1}, wm)
    if case != "plain":
        assert "bg_intensity" in m1 and wm["bg_intensity"][0] > 0


def test_host_loop_step_is_the_eager_step():
    """``multi_step.step`` on a given batch, twice, bit-equal to two eager
    steps; its metrics are 0-d."""
    cfg = AIRConfig(**SMALL)
    images, digits = _data(8, B, cfg.canvas_size)
    state0 = create_train_state(cfg, seed=0, device="cpu")
    multi = make_multi_step(cfg, K, B)
    eager = make_train_step(cfg)
    got, want = state0, state0
    for _ in range(2):
        got, gm = multi.step(got, images, digits)
        want, wm = eager(want, images, digits)
        assert_same_metrics(gm, wm)
        assert gm["loss"].shape == ()
    assert_same_state(got, want)


def test_chunks_across_an_epoch_boundary():
    """The device-data loop's chunks, the last of an epoch and the first
    of the next: the permutation buffer keeps its address and takes the
    new epoch's order, and the steps stay bit-equal to eager steps on the
    same batches; a chunk past the epoch's end clamps to its last batch."""
    cfg = AIRConfig(**SMALL)
    images, digits = _data(6, N, cfg.canvas_size)
    pipe = DeviceDataPipeline(images.numpy(), digits.numpy(), B, seed=3,
                              device="cpu")
    multi = make_multi_step(cfg, 4, B)
    state = want = create_train_state(cfg, seed=1, device="cpu")
    perm = pipe.perm()
    address, first_order = perm.data_ptr(), perm.clone()
    for _ in range(3):                       # 4 + 2 steps, then 4 more
        k = pipe.chunk(4)
        want, wm = eager_steps(cfg, want, images, digits,
                               pipe.perm().clone(), pipe.index, k)
        state, m = multi(state, pipe.images, pipe.digits, pipe.perm(),
                         pipe.index, num_steps=k)
        assert_same_metrics(m, wm)
        pipe.advance(k)
    assert pipe.epoch == 1 and state.step == 10
    assert pipe.perm().data_ptr() == address
    assert not torch.equal(pipe.perm(), first_order)
    assert_same_state(state, want)
    # batches 5, 6, 7 of a 6-batch epoch: the last two clamp to batch 5
    state, m = multi(state, images, digits, first_order, 5, num_steps=3)
    want, wm = eager_steps(cfg, want, images, digits, first_order, 5, 3)
    assert_same_metrics(m, wm)
    assert_same_state(state, want)


def test_restored_state_is_copied_in():
    """The returned state aliases the step's buffers and the next call
    takes it in place; a state the step did not return (a restored one) is
    copied in, and is not changed."""
    cfg = AIRConfig(**{**SMALL, **MAIN_OPT})
    images, digits = _data(2, N, cfg.canvas_size)
    perm = torch.arange(N)
    multi = make_multi_step(cfg, 2, B)
    state0 = create_train_state(cfg, seed=5, device="cpu")
    kept0 = clone_state(state0)
    s1, _ = multi(state0, images, digits, perm, 0)
    assert_same_state(state0, kept0)                 # not changed
    saved = clone_state(s1)                          # a checkpoint of s1
    s2, m2 = multi(s1, images, digits, perm, 2)
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(tree_leaves(_trees(s1)), tree_leaves(_trees(s2))))
    after2 = clone_state(s2)
    multi(s2, images, digits, perm, 4)               # moves the buffers on
    kept = clone_state(saved)
    restored, m = multi(saved, images, digits, perm, 2)
    assert_same_state(restored, after2)
    assert_same_metrics(m, m2)
    assert_same_state(saved, kept)                   # not changed
    want, _ = eager_steps(cfg, kept0, images, digits, perm, 0, 4)
    assert_same_state(restored, want)


def test_schedule_moves_inside_a_chunk():
    """A z_pres prior hold that ends at the second of 3 steps: the prior
    stands still over the first two steps and moves at the third, as the
    eager steps resolve it, bit for bit."""
    hold = 11
    cfg = AIRConfig(**{**SMALL, "annealing_schedules": {
        "z_pres_prior_log_odds": {**ANNEALED["z_pres_prior_log_odds"],
                                  "hold": hold}}})
    images, digits = _data(9, N, cfg.canvas_size)
    perm = torch.arange(N)
    state0 = create_train_state(cfg, seed=0, device="cpu").replace(
        step=hold - 1)
    state, m = make_multi_step(cfg, K, B)(state0, images, digits, perm, 0)
    want, wm = eager_steps(cfg, state0, images, digits, perm, 0, K)
    assert_same_metrics(m, wm)
    assert_same_state(state, want)
    odds = m["z_pres_prior_log_odds"].tolist()
    assert odds[0] == odds[1] != odds[2]


def test_step_bodies_take_tensors_only():
    """The bodies take no Python step or seed: their arguments are the
    state's trees, the batch, the draws and the step's scalars, and a call
    with tensors alone runs."""
    want = ["params", "mu", "nu", "images", "targets", "noise", "scalars"]
    cfg = AIRConfig(**SMALL)
    for body in (make_step_body(cfg), make_replica_body(cfg)):
        assert list(inspect.signature(body).parameters) == want
    multi = make_multi_step(cfg, 1, B)
    images, digits = _data(1, B, cfg.canvas_size)
    state = create_train_state(cfg, seed=0, device="cpu")
    multi.step(state, images, digits)
    slots = multi.slots
    new_p, _, _, metrics = multi.body(
        state.params, state.opt_state.mu, state.opt_state.nu, slots.images,
        slots.targets, slots.noise,
        dict(zip(multi.names, slots.row.unbind())))
    assert all(isinstance(v, torch.Tensor) for v in slots.noise.values())
    assert torch.isfinite(metrics["loss"])


def test_unported_options_raise():
    """An unroll below 1 (or not an integer) raises, in both steps; U = 2
    runs; a global batch the data axis does not divide raises."""
    cfg = AIRConfig(**SMALL)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="pipeline_unroll"):
            make_multi_step(cfg, K, B, pipeline_unroll=bad)
        with pytest.raises(ValueError, match="pipeline_unroll"):
            make_parallel_multi_step(cfg, K, B, make_mesh(2),
                                     pipeline_unroll=bad)
    images, digits = _data(1, N, cfg.canvas_size)
    state = create_train_state(cfg, seed=0, device="cpu")
    new, m = make_multi_step(cfg, K, B, pipeline_unroll=2)(
        state, images, digits, torch.arange(N), 0)
    assert new.step == K and tuple(m["loss"].shape) == (K,)
    make_parallel_multi_step(cfg, K, B, make_mesh(2), pipeline_unroll=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_parallel_multi_step(cfg, K, B + 1, make_mesh(2))
    with pytest.raises(ValueError, match="bg_schedule"):
        make_multi_step(cfg, K, B, bg_image=np.zeros(400, np.float32))
    assert fast_pipeline.DeviceDataPipeline is DeviceDataPipeline


# -------------------- the trainer ------------------------------------------
class EagerMultiStep:
    """The captured step's interface over eager train steps."""

    def __init__(self, config, num_steps, batch_size, bg_image=None,
                 bg_schedule=None, pipeline_unroll=1):
        self.num_steps, self.batch_size = num_steps, batch_size
        self.eager = make_train_step(config, bg_image=bg_image,
                                     bg_schedule=bg_schedule)

    def __call__(self, state, images, digits, perm, start, noise=None,
                 num_steps=None):
        metrics = []
        for i in range(num_steps or self.num_steps):
            lo = min((int(start) + i) * self.batch_size,
                     len(images) - self.batch_size)
            rows = perm[lo:lo + self.batch_size]
            state, m = self.eager(state, images[rows], digits[rows])
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    def step(self, state, images, targets, noise=None):
        return self.eager(state, images, targets)


@pytest.mark.skipif(jax is None, reason="needs the JAX tests' helpers")
@pytest.mark.parametrize("loop", ["device-data", "host"])
def test_trainer_is_the_eager_loop(loop, tmp_path, monkeypatch):
    """Both loops of the trainer through the captured step give the losses
    and the final params and moments of the same loop through eager steps,
    bit for bit, with evals, checkpoints and gradient summaries between
    chunks; the trainer reports the first call apart from the rest."""
    data, test = tiny_dataset(), tiny_dataset(12, seed=9)
    runs = {}
    for name in ("captured", "eager"):
        if name == "eager":
            monkeypatch.setattr(trainer, "make_multi_step", EagerMultiStep)
        cfg = AIRConfig(**{**SMALL, "learning_rate": 1e-3,
                           "adam_storage_dtype": "bfloat16"})
        tcfg = trainer.TrainerConfig(
            results_folder=str(tmp_path / name), batch_size=8, seed=3,
            max_iterations=9, num_summaries_every=4, img_summaries_every=8,
            var_summaries_every=4, grad_summaries_every=4,
            save_params_every=4, log_every=1, eval_batch_size=16,
            source_snapshot=False, multi_step=3, device="cpu",
            device_data=loop == "device-data")
        tr = trainer.Trainer(cfg, tcfg, data, test)
        result = tr.train()
        with open(tr.metrics.path) as f:
            recs = [json.loads(line) for line in f]
        runs[name] = (tr, result, {r["step"]: r["train/loss"] for r in recs
                                   if "train/loss" in r})
    (got, result, losses), (want, _, want_losses) = (runs["captured"],
                                                     runs["eager"])
    assert losses == want_losses and len(losses) == 9
    assert_same_state(got.state, want.state)
    assert result["step"] == 9 and result["first_call_ms"] > 0
    assert result["steady_ms_per_step"] > 0
    assert isinstance(got.multi_step, fast_pipeline.MultiStep)


# -------------------- profiling ----------------------------------------------
def test_step_timer_and_profile_trace(tmp_path):
    """The JAX package's tests/test_train.py checks, on the port's
    utilities: the summary after a warm-up step, and a trace directory."""
    t = profiling.StepTimer(warmup=1)
    for _ in range(3):
        with t.step(4):
            torch.ones(8).sum()
    s = t.summary()
    assert s["steps"] == 2 and s["items_per_sec"] > 0
    assert s["first_step_ms"] == 1000.0 * t.times[0]
    with profiling.profile_trace(str(tmp_path / "trace")):
        with profiling.trace_annotation("step"):
            torch.ones(3) + 1
    files = os.listdir(tmp_path / "trace")
    assert any(f.endswith(".pt.trace.json") for f in files)


@pytest.mark.skipif(jax is None, reason="needs JAX")
def test_step_timer_summary_keys_match_jax():
    ours, theirs = profiling.StepTimer(warmup=1), jax_profiling.StepTimer(
        warmup=1)
    for timer in (ours, theirs):
        for _ in range(2):
            with timer.step(2):
                pass
    assert set(ours.summary()) == set(theirs.summary())
    assert ours.summary()["steps"] == theirs.summary()["steps"] == 1


def test_compiled_cost_analysis_counts_matmul_flops():
    """2 * M * N * K for a plain matmul, and nothing for no product."""
    a, b = torch.ones(64, 128), torch.ones(128, 256)
    costs = profiling.compiled_cost_analysis(torch.matmul, a, b)
    assert costs == {"flops": 2.0 * 64 * 128 * 256}
    assert profiling.compiled_cost_analysis(torch.relu, a) == {}


# -------------------- on the card --------------------------------------------
@pytest.mark.gpu
def test_captured_step_on_the_card():
    """On the card: the captured step's replays give the eager step's bits,
    and each replay adds the launches its capture counted (kernels 1-4,
    max_steps times each per step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from air_tpu_torch.kernels import st_inline
    cfg = AIRConfig(**SMALL)
    images, digits = (t.cuda() for t in _data(1, N, cfg.canvas_size))
    perm = torch.arange(N, device="cuda")
    state0 = create_train_state(cfg, seed=0, device="cuda")
    st_inline.reset_launches()
    state, m = make_multi_step(cfg, K, B)(state0, images, digits, perm, 0)
    torch.cuda.synchronize()
    assert set(st_inline.LAUNCHES.values()) == {K * cfg.max_steps}
    want, wm = eager_steps(cfg, state0, images, digits, perm, 0, K)
    assert_same_metrics(m, wm)
    assert_same_state(state, want)


@pytest.mark.gpu
def test_unrolled_graph_on_the_card():
    """On the card: calls of 7 and 2 steps at pipeline_unroll 3 give the
    bits of U = 1, and each call adds max_steps launches of kernels 1-4 a
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from air_tpu_torch.kernels import st_inline
    cfg = AIRConfig(**SMALL)
    images, digits = (t.cuda() for t in _data(1, N, cfg.canvas_size))
    perm = torch.arange(N, device="cuda")
    state0 = create_train_state(cfg, seed=0, device="cuda")
    runs = {}
    for u in (1, 3):
        multi = make_multi_step(cfg, 9, B, pipeline_unroll=u)
        metrics = []
        state = state0
        for start, k in ((0, 7), (7, 2)):
            st_inline.reset_launches()
            state, m = multi(state, images, digits, perm, start, num_steps=k)
            torch.cuda.synchronize()
            assert set(st_inline.LAUNCHES.values()) == {k * cfg.max_steps}
            metrics.append({name: v.clone() for name, v in m.items()})
        runs[u] = (clone_state(state), {name: torch.cat(
            [m[name] for m in metrics]) for name in metrics[0]})
    assert_same_state(runs[3][0], runs[1][0])
    assert_same_metrics(runs[3][1], runs[1][1])



@pytest.mark.gpu
def test_captured_scaled_step_on_the_card():
    """On the card, at BASELINE config 4's widths (canvas 100, LSTM 512,
    VAE latent 100, the CNN; kernels 1-4 on their run-time-size path): K
    captured steps at batch 256 give the eager steps' bits, max_steps
    launches of kernels 1-4 a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from air_tpu_torch.kernels import st_inline
    from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
    cfg = DEFAULT_TRAINING_CONFIG.replace(
        cnn=True, canvas_size=100, rnn_units=512, vae_latent_dimensions=100,
        st_impl="inline")
    n, b = 512, 256
    images, digits = (t.cuda() for t in _data(2, n, cfg.canvas_size))
    perm = torch.arange(n, device="cuda")
    state0 = create_train_state(cfg, seed=0, device="cuda")
    st_inline.reset_launches()
    state, m = make_multi_step(cfg, K, b)(state0, images, digits, perm, 0)
    torch.cuda.synchronize()
    assert set(st_inline.LAUNCHES.values()) == {K * cfg.max_steps}
    want, wm = eager_steps(cfg, state0, images, digits, perm, 0, K, b)
    assert_same_metrics(m, wm)
    assert_same_state(state, want)
