"""The port's training pieces (air_tpu_torch.models.air.init_air_params,
train/state.py, train/steps.py, train/metrics.py) against the JAX package's,
on the CPU, with the same parameters and the same draws.

The train step itself is held against the JAX package's in
tests/test_torch_train_step.py. Tolerances: summaries 1e-4 (eval forward,
as tests/test_torch_model.py) or 1e-6 (the same outputs); the optimizer
alone, from identical gradients: parameters within 1e-6 and the moments bit
for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from air_tpu.models.air import air_forward as jax_forward
from air_tpu.models.air import init_air_params as jax_init
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.train.metrics import summarize_outputs as jax_summarize
from air_tpu.train.state import make_optimizer as jax_make_optimizer
from air_tpu.train.steps import bg_intensity as jax_bg_intensity
from air_tpu.train.steps import make_eval_summary_step as jax_eval_summary
from air_tpu_torch.interop import opt_state_from_jax, params_from_jax
from air_tpu_torch.models.air import air_forward, init_air_params
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.train.metrics import summarize_outputs
from air_tpu_torch.train.state import (apply_updates, clip_by_global_norm,
                                       create_train_state, global_norm,
                                       make_optimizer)
from air_tpu_torch.train.steps import (bg_intensity, make_eval_summary_step,
                                       make_train_step)
from air_tpu_torch.tree import tree_leaves, tree_leaves_with_path
from tests.test_model import SMALL as JAX_SMALL_MLP
from tests.test_torch_model import SMALL, jax_noise

TOL = dict(rtol=1e-4, atol=1e-4)
# the main path's optimizer: bf16-stored Adam moments, clip 1.0, lr 1e-4
MAIN_OPT = dict(adam_storage_dtype="bfloat16", gradient_clipping_norm=1.0,
                learning_rate=1e-4)
LR_SCHEDULE = {"learning_rate": {"init": 1e-3, "factor": 0.5, "iters": 2,
                                 "min": 1e-5}}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------- init ----------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"cnn": False}, {"learn_background": True},
    {"learn_background": True, "bg": True}], ids=str)
def test_init_air_params_matches_jax_tree(kw):
    kw = dict(kw)
    bg = np.linspace(0.0, 1.0, 400, dtype=np.float32) if kw.pop("bg", 0) \
        else None
    jcfg, cfg = JaxConfig(**{**SMALL, **kw}), AIRConfig(**{**SMALL, **kw})
    want = to_np(jax_init(jax.random.PRNGKey(0), jcfg, background_init=bg))
    got = init_air_params(torch.Generator().manual_seed(0), cfg,
                          background_init=bg)
    w_leaves = dict(tree_leaves_with_path(want))
    g_leaves = dict(tree_leaves_with_path(got))
    assert list(g_leaves) == list(w_leaves)
    for path, t in g_leaves.items():
        w = w_leaves[path]
        assert t.dtype == torch.float32 and w.dtype == np.float32
        shape = tuple(t.shape)
        if path[0] == "cnn" and path[-1] == "w":
            shape = tuple(t.permute(2, 3, 1, 0).shape)       # OIHW -> HWIO
        assert shape == w.shape, path
        if path[-1] in ("b", "bias"):
            assert not t.any()
        elif path[-1] in ("w", "kernel"):
            if path[0] == "cnn":
                o, i, kh, kw_ = t.shape
                fan_in, fan_out = kh * kw_ * i, kh * kw_ * o
            else:
                fan_in, fan_out = t.shape
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(t.abs().max()) <= limit
            if t.numel() >= 200:          # spread over the range, centred
                assert float(t.abs().max()) > 0.9 * limit
                assert abs(float(t.mean())) < 0.2 * limit
    if "background" in g_leaves:
        np.testing.assert_allclose(g_leaves[("background",)].numpy(),
                                   w_leaves[("background",)], rtol=1e-6,
                                   atol=1e-6)


def test_create_train_state():
    cfg = AIRConfig(**SMALL, **MAIN_OPT)
    a = create_train_state(cfg, seed=3, device="cpu")
    b = create_train_state(cfg, seed=3, device="cpu")
    assert a.step == 0 and a.seed == 3
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert a.opt_state.count == 0 and a.opt_state.schedule_count is None
    for m in tree_leaves(a.opt_state.mu) + tree_leaves(a.opt_state.nu):
        assert m.dtype == torch.bfloat16 and not m.any()
    sched = create_train_state(
        AIRConfig(**SMALL, annealing_schedules=LR_SCHEDULE), device="cpu")
    assert sched.opt_state.schedule_count == 0
    assert tree_leaves(sched.opt_state.mu)[0].dtype == torch.float32


# -------------------- optimizer ------------------------------------------

OPT_CASES = {
    "bf16-clipped": dict(MAIN_OPT),
    "bf16-unclipped": dict(MAIN_OPT, gradient_clipping_norm=1e9),
    "fp32-clipped": dict(MAIN_OPT, adam_storage_dtype="float32"),
    "fp32-no-clip": dict(MAIN_OPT, adam_storage_dtype="float32",
                         gradient_clipping_norm=None),
    "freeze-background": dict(MAIN_OPT, learn_background=True,
                              freeze_background=True),
    "bf16-lr-schedule": dict(MAIN_OPT, annealing_schedules=LR_SCHEDULE),
    "fp32-lr-schedule": dict(MAIN_OPT, adam_storage_dtype="float32",
                             annealing_schedules=LR_SCHEDULE),
}


def _run_both_optimizers(kw, grads_fn, steps=3):
    """``steps`` updates of the same params by both packages' optimizers
    from the same gradients; returns (port params, port state, JAX params,
    JAX state)."""
    kw = {**SMALL, "learn_background": True, **kw}
    jcfg, cfg = JaxConfig(**kw), AIRConfig(**kw)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    jopt = jax_make_optimizer(jcfg)
    jstate = jopt.init(jparams)
    params = params_from_jax(to_np(jparams), "cpu")
    opt = make_optimizer(cfg)
    state = opt.init(params)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        g = jax.tree_util.tree_map(lambda p: grads_fn(rng, p.shape),
                                   to_np(jparams))
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updates, state = opt.update(params_from_jax(g, "cpu"), state)
        params = apply_updates(params, updates)
    return params, state, jparams, jstate


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Three steps from identical gradients. The gradients are small
    integers, so every sum of squares, and with it the global norm, is exact
    in any order: the clip then scales both packages' gradients by the same
    bits, and the moments must agree bit for bit (bfloat16 demotion by
    round-to-nearest-even included). test_clip_matches_optax covers float
    gradients."""
    params, state, jparams, jstate = _run_both_optimizers(
        OPT_CASES[case],
        lambda rng, shape: rng.integers(-3, 4, shape).astype(np.float32))
    want = opt_state_from_jax(to_np(jax.tree_util.tree_leaves(jstate)),
                              params, "cpu")
    assert (state.count, state.schedule_count) == (want.count,
                                                   want.schedule_count)
    for got_m, want_m in ((state.mu, want.mu), (state.nu, want.nu)):
        for a, b in zip(tree_leaves(got_m), tree_leaves(want_m)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(params),
                    tree_leaves(params_from_jax(to_np(jparams), "cpu"))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    if OPT_CASES[case].get("freeze_background"):
        torch.testing.assert_close(
            params["background"],
            torch.full_like(params["background"], -4.0), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["bf16-clipped", "fp32-clipped"])
def test_clip_matches_optax(case):
    """Float gradients: the global norm agrees to an ulp (the sums of
    squares are taken in another order), the clipped gradients to 1e-6
    relative, and three optimizer steps to 1e-6 on the parameters."""
    rng = np.random.default_rng(4)
    jparams = to_np(jax_init(jax.random.PRNGKey(0), JaxConfig(**SMALL)))
    g = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = params_from_jax(g, "cpu")
    want_norm = float(optax.global_norm(jg))
    got_norm = float(global_norm(tg))
    assert abs(got_norm - want_norm) <= 2 * np.spacing(np.float32(want_norm))
    want, _ = optax.clip_by_global_norm(1.0).update(jg, optax.EmptyState())
    got = clip_by_global_norm(tg, 1.0)
    for a, b in zip(tree_leaves(got),
                    tree_leaves(params_from_jax(to_np(want), "cpu"))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)
    params, _, jparams, _ = _run_both_optimizers(
        OPT_CASES[case],
        lambda rng, shape: rng.normal(size=shape).astype(np.float32))
    for a, b in zip(tree_leaves(params),
                    tree_leaves(params_from_jax(to_np(jparams), "cpu"))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_freeze_background_needs_learn_background():
    with pytest.raises(ValueError):
        make_optimizer(AIRConfig(**SMALL, freeze_background=True))


# -------------------- train step -----------------------------------------

@pytest.mark.parametrize("schedule", [
    None, {"target": 0.5}, {"target": 0.8, "start": 3, "ramp": 4},
    {"target": 1.0, "start": 2, "ramp": 0}], ids=str)
def test_bg_intensity_matches_jax(schedule):
    for step in range(9):
        assert float(bg_intensity(schedule, step)) == float(
            jax_bg_intensity(schedule, step))


def _images(batch, cs, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(batch, cs * cs)).astype(np.float32)
    return images, (np.arange(batch) % 3).astype(np.int32)


def test_train_step_options_of_later_slices_raise():
    """pmean_axis takes a parallel Mesh (a JAX axis name raises; the
    data-parallel step is tests/test_torch_parallel.py's), a bg_image
    without its schedule raises; schedules_fn resolves the hyperparameters
    from the knobs the step is given."""
    cfg = AIRConfig(**SMALL)
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(cfg, pmean_axis="data")
    with pytest.raises(ValueError):
        make_train_step(cfg, bg_image=np.zeros(400, np.float32))
    seen = []

    def schedules_fn(knobs):
        seen.append(knobs)
        return {"z_pres_prior_log_odds": {"init": knobs["init"],
                                          "factor": 0.5, "iters": 2}}

    step = make_train_step(cfg, schedules_fn=schedules_fn)
    state = create_train_state(cfg, seed=0, device="cpu").replace(step=2)
    images, targets = _images(4, SMALL["canvas_size"])
    _, metrics = step(state, images, targets, {"init": 7.0})
    assert seen == [{"init": 7.0}]
    assert float(metrics["z_pres_prior_log_odds"]) == 3.5


def test_step_draws_come_from_seed_and_step():
    """Without injected noise a step's draws depend on (seed, step) only."""
    cfg = AIRConfig(**SMALL, **MAIN_OPT)
    images, targets = _images(4, SMALL["canvas_size"])
    step = make_train_step(cfg)
    state = create_train_state(cfg, seed=0, device="cpu")
    _, m1 = step(state, images, targets)
    _, m2 = step(state, images, targets)
    _, m3 = step(state.replace(step=1), images, targets)
    _, m4 = step(state.replace(seed=1), images, targets)
    assert float(m1["loss"]) == float(m2["loss"])
    assert float(m3["loss"]) != float(m1["loss"])
    assert float(m4["loss"]) != float(m1["loss"])


def test_golden_loss_value():
    """tests/test_gradients.py's golden loss (2523.18 within 5e-3), from the
    port's forward with JAX's init_air_params(PRNGKey(0)) and JAX's draws."""
    jcfg = JAX_SMALL_MLP
    params = params_from_jax(to_np(jax_init(jax.random.PRNGKey(0), jcfg)),
                             "cpu")
    images = np.array(jax.random.uniform(jax.random.PRNGKey(1),
                                         (6, jcfg.canvas_size ** 2)))
    targets = np.array([0, 1, 2, 1, 0, 2], np.int32)
    noise = jax_noise(jax.random.PRNGKey(2), jcfg, 6)
    for st_impl in ("xla", "inline"):
        import dataclasses
        cfg = AIRConfig(**{**dataclasses.asdict(jcfg), "st_impl": st_impl})
        out = air_forward(params, cfg, torch.from_numpy(images),
                          torch.from_numpy(targets), train=True, noise=noise)
        got = float(out.loss)
        assert abs(got - 2523.18) / 2523.18 < 5e-3, (st_impl, got)


# -------------------- eval summaries -------------------------------------

def test_summarize_outputs_matches_jax():
    """The same keys and values from the same outputs (JAX's, carried over),
    NaN where a slice is empty."""
    jcfg = JaxConfig(**SMALL)
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    images, _ = _images(9, SMALL["canvas_size"], seed=3)
    targets = np.array([0, 1, 2, 2, 1, 0, 0, 0, 1], np.int32)
    out = jax_forward(params, jcfg, jnp.asarray(images),
                      jnp.asarray(targets), jax.random.PRNGKey(4),
                      train=False)
    want = jax_summarize(out, jnp.asarray(targets), jcfg.max_steps,
                         jcfg.max_digits)
    got = summarize_outputs(
        type(out)(*(torch.from_numpy(np.array(v)) for v in out)),
        torch.from_numpy(targets), jcfg.max_steps, jcfg.max_digits)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert any(np.isnan(float(v)) for v in want.values())


@pytest.mark.parametrize("st_impl", ["inline", "pallas", "xla"])
def test_eval_summary_step_matches_jax(st_impl):
    kw = {**SMALL, **MAIN_OPT, "st_impl": st_impl,
          "annealing_schedules": {"z_pres_prior_log_odds": {
              "init": 100.0, "min": 1e-3, "factor": 0.5, "iters": 3,
              "log": True}}}
    jcfg = JaxConfig(**kw)
    params = jax_init(jax.random.PRNGKey(5), jcfg)
    images, targets = _images(8, SMALL["canvas_size"], seed=5)
    key = jax.random.PRNGKey(6)
    want = jax_eval_summary(jcfg)(params, jnp.asarray(images),
                                  jnp.asarray(targets), key,
                                  jnp.asarray(4, jnp.int32))
    got = make_eval_summary_step(AIRConfig(**kw))(
        params_from_jax(to_np(params), "cpu"), torch.from_numpy(images),
        torch.from_numpy(targets), 4, noise=jax_noise(key, jcfg, 8))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **TOL)


# -------------------- convergence ----------------------------------------

def test_loss_decreases_over_training():
    """tests/test_train.py's convergence check, through the port: overfit a
    centred blob with a reachable window and the annealed z_pres prior; the
    mean reconstruction loss of the last 50 steps ends below 0.85 of the
    blank-canvas level. The attention goes through the inline read and
    write Functions (their plain versions on the CPU)."""
    cfg = AIRConfig(
        max_steps=1, max_digits=1, rnn_units=32, canvas_size=20,
        windows_size=8, vae_latent_dimensions=6,
        vae_recognition_units=(32, 16), vae_generative_units=(16, 32),
        scale_hidden_units=8, shift_hidden_units=8, z_pres_hidden_units=8,
        cnn=False, train=True, st_impl="inline",
        scale_prior_mean=2.0, scale_prior_variance=0.01,
        vae_likelihood_std=0.0, learning_rate=3e-3,
        gradient_clipping_norm=100.0,
        annealing_schedules={"z_pres_prior_log_odds": {
            "init": 10000.0, "min": 1e-9, "factor": 0.1, "iters": 100000,
            "log": True}})
    cs = cfg.canvas_size
    img = np.zeros((cs, cs), np.float32)
    img[7:13, 7:13] = 1.0
    images = torch.from_numpy(np.tile(img.reshape(1, -1), (32, 1)))
    digits = torch.ones(32, dtype=torch.int32)
    state = create_train_state(cfg, seed=0, device="cpu")
    step_fn = make_train_step(cfg)
    recons = []
    for _ in range(500):
        state, m = step_fn(state, images, digits)
        assert np.isfinite(float(m["loss"]))
        recons.append(float(m["reconstruction_loss"]))
    blank_level = float(img.sum()) * -np.log(10e-10)
    assert np.mean(recons[-50:]) < 0.85 * blank_level
