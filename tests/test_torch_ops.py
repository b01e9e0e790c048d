"""The port's ops (air_tpu_torch.ops) against the JAX package's, on the same
inputs and the same draws: JAX draws its noise from a key, the test draws
the same numbers with jax.random and hands them to the port. Tolerance
1e-6 abs: float32 elementwise math, at most one ulp apart."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.ops import concrete as jcon
from air_tpu.ops import gaussian as jgau
from air_tpu.ops import schedules as jsch
from air_tpu_torch.ops import concrete as tcon
from air_tpu_torch.ops import gaussian as tgau
from air_tpu_torch.ops import schedules as tsch
from air_tpu_torch.ops import transformer as ttr

# air_tpu.ops re-exports a function named ``transformer``: import the module
jtr = importlib.import_module("air_tpu.ops.transformer")

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_concrete_pre_sigmoid_sample(temperature):
    key = jax.random.PRNGKey(0)
    log_odds = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    want = jcon.concrete_binary_pre_sigmoid_sample(
        key, jnp.asarray(log_odds), temperature)
    u = jax.random.uniform(key, (64,), jnp.float32)     # JAX's own draw
    got = tcon.concrete_binary_pre_sigmoid_sample(_t(u), _t(log_odds),
                                                  temperature)
    _close(got, want)


def test_logistic_noise():
    key = jax.random.PRNGKey(1)
    want = jcon._logistic_noise(key, (256,))
    got = tcon.logistic_noise(_t(jax.random.uniform(key, (256,))))
    _close(got, want)


@pytest.mark.parametrize("prior_log_odds,temperature", [
    (-2.0, 1.0), (9.2103405, 1.0), (-0.01, 0.7)])
def test_concrete_kl_mc_sample(prior_log_odds, temperature):
    rng = np.random.default_rng(2)
    y = rng.normal(size=(32,)).astype(np.float32) * 3
    post = rng.normal(size=(32,)).astype(np.float32)
    want = jcon.concrete_binary_kl_mc_sample(
        jnp.asarray(y), prior_log_odds, temperature, jnp.asarray(post),
        temperature)
    got = tcon.concrete_binary_kl_mc_sample(
        _t(y), prior_log_odds, temperature, _t(post), temperature)
    _close(got, want, atol=ATOL * 10)   # values up to ~10: one ulp is ~1e-6


def test_sample_from_mvn():
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(16, 2)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=(16, 2)).astype(np.float32)
    want = jgau.sample_from_mvn(key, jnp.asarray(mean), jnp.asarray(var))
    eps = jax.random.normal(key, (16, 2), jnp.float32)
    _close(tgau.sample_from_mvn(_t(eps), _t(mean), _t(var)), want)


@pytest.mark.parametrize("prior_mean,prior_variance", [
    (-1.0, 0.05), (0.0, 1.0), (0.0, 0.1)])
def test_gaussian_kl(prior_mean, prior_variance):
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(16, 2)).astype(np.float32) * 0.5
    logvar = rng.normal(size=(16, 2)).astype(np.float32) * 0.3
    want = jgau.gaussian_kl(jnp.asarray(mean), jnp.asarray(logvar),
                            prior_mean, prior_variance)
    got = tgau.gaussian_kl(_t(mean), _t(logvar), prior_mean, prior_variance)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=ATOL)


SCHEDULES = [
    {"init": 10000.0, "min": 1e-9, "factor": 0.1, "iters": 3000,
     "staircase": False, "log": True},
    {"init": 10000.0, "min": 1e-9, "factor": 0.1, "iters": 3000,
     "log": True, "hold": 15000},
    {"init": 1.0, "factor": 0.5, "iters": 1000, "staircase": True,
     "offset": -1.0},
    {"init": 0.3, "factor": 2.0, "iters": 500, "max": 0.9},
]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("step", [0, 1, 2500, 16000, 40000])
def test_annealed_value(schedule, step):
    want = jsch.annealed_value(schedule, step)
    got = tsch.annealed_value(schedule, step)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=ATOL)


def test_resolve_annealed():
    defaults = {"z_pres_prior_log_odds": -0.01, "learning_rate": 1e-4}
    sched = {"z_pres_prior_log_odds": SCHEDULES[0]}
    want = jsch.resolve_annealed(sched, defaults, 0)
    got = tsch.resolve_annealed(sched, defaults, 0)
    assert got["learning_rate"] == want["learning_rate"] == 1e-4
    _close(got["z_pres_prior_log_odds"], want["z_pres_prior_log_odds"])
    with pytest.raises(KeyError):
        tsch.resolve_annealed({"nope": SCHEDULES[0]}, defaults, 0)


def _st_inputs(b, in_dim, seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, in_dim, in_dim)).astype(np.float32)
    s = rng.uniform(0.1, 1.0, b).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, b).astype(np.float32)
    y = rng.uniform(-1.0, 1.0, b).astype(np.float32)
    return images, s, x, y


# XLA's fused jnp.linspace rounds some points of linspace(-1, 1, n) one ulp
# (<= 1.2e-7) away from the port's float32 formula. Multiplied into pixel
# positions of up to ~50 that is a few ulp of the position, so the weights
# and outputs differ by up to ~1e-5. The transformer twin is therefore held
# at 1e-6 with JAX given the port's grid (the algebra after the grid), and
# at 1e-5 with each framework's own grid.
ST_CASES = [(True, ATOL), (False, 1e-5)]


@pytest.fixture
def grid(request, monkeypatch):
    same_grid, atol = request.param
    if same_grid:
        monkeypatch.setattr(
            jtr.jnp, "linspace",
            lambda start, stop, n: jnp.asarray(ttr._linspace(n, "cpu").numpy()))
    return atol


def test_linspace_within_one_ulp():
    for n in (8, 12, 20, 28, 30, 50):
        np.testing.assert_allclose(ttr._linspace(n, "cpu").numpy(),
                                   np.asarray(jnp.linspace(-1.0, 1.0, n)),
                                   rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("grid", ST_CASES, indirect=True)
@pytest.mark.parametrize("out_dim,in_dim", [(28, 50), (50, 28), (8, 20)])
def test_axis_weight_matrix(out_dim, in_dim, grid):
    _, s, x, _ = _st_inputs(6, in_dim, 5)
    want = jtr._axis_weight_matrix(jnp.asarray(s), jnp.asarray(x), out_dim,
                                   in_dim)
    _close(ttr._axis_weight_matrix(_t(s), _t(x), out_dim, in_dim), want, grid)


@pytest.mark.parametrize("grid", ST_CASES, indirect=True)
@pytest.mark.parametrize("cs,ws", [(50, 28), (30, 12)])
def test_attention_read(cs, ws, grid):
    images, s, x, y = _st_inputs(5, cs, 6)
    want = jtr.attention_read(*map(jnp.asarray, (images, s, x, y)), ws)
    _close(ttr.attention_read(*map(_t, (images, s, x, y)), ws), want, grid)


@pytest.mark.parametrize("grid", ST_CASES, indirect=True)
@pytest.mark.parametrize("cs,ws", [(50, 28), (30, 12)])
def test_attention_write(cs, ws, grid):
    windows, s, x, y = _st_inputs(5, ws, 7)
    want = jtr.attention_write(*map(jnp.asarray, (windows, s, x, y)), cs)
    _close(ttr.attention_write(*map(_t, (windows, s, x, y)), cs), want, grid)


@pytest.mark.parametrize("grid", ST_CASES, indirect=True)
def test_separable_transform_anisotropic(grid):
    images, s, x, y = _st_inputs(4, 20, 8)
    sy = np.flip(s).copy()
    want = jtr.separable_transform(
        *map(jnp.asarray, (images, s, sy, x, y)), (8, 10))
    _close(ttr.separable_transform(*map(_t, (images, s, sy, x, y)), (8, 10)),
           want, grid)


def test_clamp_cancel_is_not_ported():
    _, s, x, _ = _st_inputs(2, 20, 9)
    with pytest.raises(NotImplementedError):
        ttr._axis_weight_matrix(_t(s), _t(x), 8, 20, pad_mode="clamp_cancel")
