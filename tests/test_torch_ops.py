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
    """Ported since: ``pad_mode="clamp_cancel"`` builds the JAX package's
    one-hot weights from the clamped corners (on the port's grid), and an
    unknown pad mode raises ValueError in both packages."""
    _, s, x, _ = _st_inputs(2, 20, 9)
    with pytest.raises(ValueError, match="pad_mode"):
        ttr._axis_weight_matrix(_t(s), _t(x), 8, 20, pad_mode="reflect")
    with pytest.raises(ValueError, match="pad_mode"):
        jtr._axis_weight_matrix(jnp.asarray(s), jnp.asarray(x), 8, 20,
                                pad_mode="reflect")
    got = ttr._axis_weight_matrix(_t(s), _t(x), 8, 20, pad_mode="clamp_cancel")
    assert got.shape == (2, 8, 20)


# --- clamp_cancel and the general transformer --------------------------------

def _clamp_scalars(b, seed):
    """Scales and shifts whose windows reach past the image on both sides,
    so that the clamped corners and the one-pixel band are exercised."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 1.5, b).astype(np.float32),
            rng.uniform(-1.4, 1.4, b).astype(np.float32))


@pytest.mark.parametrize("out_dim,in_dim", [(28, 50), (50, 28), (8, 20)])
def test_clamp_cancel_weights_and_gradients_match_jax(out_dim, in_dim,
                                                      monkeypatch):
    """Values to 1e-5 and the gradients of a weighted sum of the weights
    in (scale, shift) to 1e-4, JAX given the port's grid."""
    monkeypatch.setattr(jtr.jnp, "linspace", lambda start, stop, n:
                        jnp.asarray(ttr._linspace(n, "cpu").numpy()))
    s, x = _clamp_scalars(16, out_dim + in_dim)
    r = np.random.default_rng(1).normal(
        size=(16, out_dim, in_dim)).astype(np.float32)

    def jax_loss(s, x):
        return jnp.sum(jnp.asarray(r) * jtr._axis_weight_matrix(
            s, x, out_dim, in_dim, "clamp_cancel"))

    want = jtr._axis_weight_matrix(jnp.asarray(s), jnp.asarray(x), out_dim,
                                   in_dim, "clamp_cancel")
    ts, tx = _t(s).requires_grad_(True), _t(x).requires_grad_(True)
    got = ttr._axis_weight_matrix(ts, tx, out_dim, in_dim, "clamp_cancel")
    _close(got.detach(), want, 1e-5)
    assert float((got.detach().sum(-1) == 0).float().sum()) > 0  # off image
    torch.sum(_t(r) * got).backward()
    for g, w in zip((ts.grad, tx.grad),
                    jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(s),
                                                       jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _thetas(b, seed):
    """Affine thetas with rotation and shear (not axis-aligned)."""
    rng = np.random.default_rng(seed)
    theta = np.zeros((b, 2, 3), np.float32)
    s = rng.uniform(0.2, 1.2, b)
    theta[:, 0, 0], theta[:, 1, 1] = s, s * rng.uniform(0.8, 1.2, b)
    theta[:, 0, 1] = rng.uniform(-0.3, 0.3, b)
    theta[:, 1, 0] = rng.uniform(-0.3, 0.3, b)
    theta[:, :, 2] = rng.uniform(-0.8, 0.8, (b, 2))
    return theta


@pytest.mark.parametrize("grid", ST_CASES, indirect=True)
@pytest.mark.parametrize("hw,out,c", [((50, 50), (28, 28), 1),
                                      ((20, 30), (12, 9), 3)])
def test_transformer_matches_jax_and_the_oracle(hw, out, c, grid):
    from tests.oracles import np_transformer
    rng = np.random.default_rng(c)
    images = rng.uniform(size=(4, *hw, c)).astype(np.float32)
    theta = _thetas(4, c)
    got = ttr.transformer(_t(images), _t(theta), out)
    assert got.shape == (4, *out, c)
    _close(got, jtr.transformer(jnp.asarray(images), jnp.asarray(theta),
                                out), max(grid, 1e-5))
    np.testing.assert_allclose(got.numpy(), np_transformer(images, theta, out),
                               rtol=0, atol=1e-4)


def test_transformer_gradients_match_jax(monkeypatch):
    monkeypatch.setattr(jtr.jnp, "linspace", lambda start, stop, n:
                        jnp.asarray(ttr._linspace(n, "cpu").numpy()))
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(3, 20, 20, 2)).astype(np.float32)
    theta = _thetas(3, 3)
    r = rng.normal(size=(3, 12, 12, 2)).astype(np.float32)

    def jax_loss(im, th):
        return jnp.sum(jnp.asarray(r) * jtr.transformer(im, th, (12, 12)))

    ti, tt = (_t(images).requires_grad_(True),
              _t(theta).requires_grad_(True))
    torch.sum(_t(r) * ttr.transformer(ti, tt, (12, 12))).backward()
    for g, w in zip((ti.grad, tt.grad), jax.grad(jax_loss, argnums=(0, 1))(
            jnp.asarray(images), jnp.asarray(theta))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_batch_transformer_shapes_and_values(monkeypatch):
    """N thetas per image, image-major, each the transformer of its image;
    [B, N, 6] and [B, N, 2, 3] thetas alike; JAX's values."""
    monkeypatch.setattr(jtr.jnp, "linspace", lambda start, stop, n:
                        jnp.asarray(ttr._linspace(n, "cpu").numpy()))
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    thetas = _thetas(6, 4).reshape(2, 3, 2, 3)
    got = ttr.batch_transformer(_t(images), _t(thetas), (8, 10))
    assert got.shape == (6, 8, 10, 3)
    flat = ttr.batch_transformer(_t(images), _t(thetas.reshape(2, 3, 6)),
                                 (8, 10))
    assert torch.equal(got, flat)
    for i in range(2):
        for n in range(3):
            one = ttr.transformer(_t(images[i:i + 1]),
                                  _t(thetas[i, n][None]), (8, 10))
            assert torch.equal(got[3 * i + n], one[0])
    _close(got, jtr.batch_transformer(jnp.asarray(images),
                                      jnp.asarray(thetas), (8, 10)), 1e-5)
