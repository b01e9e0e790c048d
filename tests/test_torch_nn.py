"""The port's NN modules (air_tpu_torch.nn) against the JAX package's, with
the parameters of init_air_params carried over by params_from_jax.
Tolerance 1e-5: float32 products of up to 1408 terms, summed in another
order by each framework."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.models.air import init_air_params
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.nn.cnn import cnn_apply as jax_cnn
from air_tpu.nn.layers import dense_apply as jax_dense
from air_tpu.nn.layers import mlp_apply as jax_mlp
from air_tpu.nn.layers import two_layer_head_apply as jax_head
from air_tpu.nn.lstm import lstm_apply as jax_lstm
from air_tpu.nn.vae import vae_apply as jax_vae
from air_tpu_torch.interop import params_from_jax
from air_tpu_torch.nn.cnn import cnn_apply
from air_tpu_torch.nn.layers import dense_apply, mlp_apply, two_layer_head_apply
from air_tpu_torch.nn.lstm import lstm_apply, lstm_zero_state
from air_tpu_torch.nn.vae import vae_apply

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    """Full-width robust-default parameters (CNN encoder)."""
    cfg = JaxConfig(cnn=True)
    jp = init_air_params(jax.random.PRNGKey(0), cfg)
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_jax(jp_np, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_carry_over(params):
    jp, tp = params
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert node.dtype == torch.float32
        if path[0].key == "cnn" and path[-1].key == "w":
            np.testing.assert_array_equal(
                node.numpy(), np.asarray(leaf).transpose(3, 2, 0, 1))
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_dense_and_mlp(params):
    jp, tp = params
    x = np.random.default_rng(0).normal(size=(6, 784)).astype(np.float32)
    _close(dense_apply(tp["vae"]["rec"][0], torch.from_numpy(x)),
           jax_dense(jp["vae"]["rec"][0], jnp.asarray(x)))
    _close(mlp_apply(tp["vae"]["rec"], torch.from_numpy(x)),
           jax_mlp(jp["vae"]["rec"], jnp.asarray(x)))


@pytest.mark.parametrize("head", ["scale_mean", "shift_log_variance",
                                  "z_pres_log_odds"])
def test_two_layer_head(params, head):
    jp, tp = params
    h = np.random.default_rng(1).normal(size=(6, 256)).astype(np.float32)
    _close(two_layer_head_apply(tp[head], torch.from_numpy(h)),
           jax_head(jp[head], jnp.asarray(h)))


def test_lstm_two_steps(params):
    """Gate order (i, j, f, o) and forget_bias 1.0, over two steps from the
    zero state."""
    jp, tp = params
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 1152)).astype(np.float32)
    j_state = (jnp.zeros((5, 256)), jnp.zeros((5, 256)))
    t_state = lstm_zero_state(5, 256, "cpu")
    for _ in range(2):
        jh, j_state = jax_lstm(jp["lstm"], j_state, jnp.asarray(x))
        th, t_state = lstm_apply(tp["lstm"], t_state, torch.from_numpy(x))
        _close(th, jh)
        _close(t_state[0], j_state[0])


def test_cnn_nhwc_flatten(params):
    jp, tp = params
    images = np.random.default_rng(3).uniform(size=(4, 2500)).astype(
        np.float32)
    want = jax_cnn(jp["cnn"], jnp.asarray(images), 50, 8)
    got = cnn_apply(tp["cnn"], torch.from_numpy(images), 50, 8)
    assert got.shape == (4, 12 * 12 * 8)
    _close(got, want)


@pytest.mark.parametrize("likelihood_std", [0.3, 0.0])
def test_vae(params, likelihood_std):
    """Noise from JAX's key split: (latent, out) = split(key)."""
    jp, tp = params
    key = jax.random.PRNGKey(4)
    win = np.random.default_rng(4).uniform(size=(6, 784)).astype(np.float32)
    want = jax_vae(jp["vae"], key, jnp.asarray(win), likelihood_std)
    k_latent, k_out = jax.random.split(key)
    latent_eps = np.array(jax.random.normal(k_latent, (6, 50), jnp.float32))
    out_noise = np.array(jax.random.normal(k_out, (6, 784), jnp.float32))
    got = vae_apply(tp["vae"], torch.from_numpy(win),
                    torch.from_numpy(latent_eps), torch.from_numpy(out_noise),
                    likelihood_std)
    for g, w in zip(got, want):
        _close(g, w)
