"""The port's AIR forward pass (air_tpu_torch.models.air.air_forward)
against the JAX package's, every AIROutputs field, with the same parameters
and the same draws: the noise is rebuilt from JAX's key tree and fed to the
port. JAX takes its TPU kernels in interpret mode: the pallas ones where the
port takes st_impl="pallas", else the inline ones.

Tolerance 1e-4 abs/rel on values: the LSTM's [B, 1408] x [1408, 1024]
product and the 2500-pixel BCE sums are reduced in another order by each
framework, and XLA fuses multiply-adds that PyTorch rounds twice.
rec_num_digits must be exactly equal."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.models.air import air_forward as jax_forward
from air_tpu.models.air import init_air_params
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_DEFAULT
from air_tpu.train.checkpoint import checkpoint_arch as jax_arch
from air_tpu.train.checkpoint import load_params as jax_load_params
from air_tpu.train.steps import make_eval_step as jax_eval_step
from air_tpu_torch.interop import params_from_jax
from air_tpu_torch.models.air import air_forward, draw_noise
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
from air_tpu_torch.ops.transformer import _linspace
from air_tpu_torch.train.checkpoint import checkpoint_arch, load_params
from air_tpu_torch.train.steps import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
CKPTS = [CNN_CKPT, os.path.join(REPO, "model", "air-model-80000.npz")]
TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = dict(max_steps=2, max_digits=2, rnn_units=32, canvas_size=20,
             windows_size=8, vae_latent_dimensions=6,
             vae_recognition_units=(32, 16), vae_generative_units=(16, 32),
             scale_hidden_units=8, shift_hidden_units=8,
             z_pres_hidden_units=8, cnn=True, st_impl="inline")


def jax_noise(key, cfg, batch):
    """The draws air_tpu's air_forward makes from ``key``: split(key, T),
    then split(k, 4) -> scale/shift/vae/zpres, then split(k_vae) ->
    latent/out."""
    out = {k: [] for k in ("scale", "shift", "vae_latent", "vae_out",
                           "z_pres_u")}
    for k in jax.random.split(key, cfg.max_steps):
        k_scale, k_shift, k_vae, k_zpres = jax.random.split(k, 4)
        k_latent, k_out = jax.random.split(k_vae)
        f32 = jnp.float32
        out["scale"].append(jax.random.normal(k_scale, (batch, 1), f32))
        out["shift"].append(jax.random.normal(k_shift, (batch, 2), f32))
        out["vae_latent"].append(jax.random.normal(
            k_latent, (batch, cfg.vae_latent_dimensions), f32))
        out["vae_out"].append(jax.random.normal(
            k_out, (batch, cfg.windows_size ** 2), f32))
        out["z_pres_u"].append(jax.random.uniform(k_zpres, (batch,), f32))
    return {k: torch.from_numpy(np.stack([np.array(a) for a in v]))
            for k, v in out.items()}


def assert_outputs_close(got, want):
    assert got._fields == want._fields
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        if field == "rec_num_digits":
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=field, **TOL)


@pytest.mark.parametrize("st_impl", ["inline", "pallas", "xla"])
@pytest.mark.parametrize("train", [True, False])
def test_small_config_matches_jax(train, st_impl):
    # JAX takes its pallas kernels for the port's pallas path, else inline
    jax_impl = "pallas" if st_impl == "pallas" else "inline"
    jax_cfg = JaxConfig(**{**SMALL, "st_impl": jax_impl})
    params = init_air_params(jax.random.PRNGKey(0), jax_cfg)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(6, 400)).astype(np.float32)
    targets = np.array([0, 1, 2, 1, 0, 2], np.int32)
    key = jax.random.PRNGKey(1)
    want = jax_forward(params, jax_cfg, jnp.asarray(images),
                       jnp.asarray(targets), key, train=train)
    got = air_forward(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        AIRConfig(**{**SMALL, "st_impl": st_impl}),
        torch.from_numpy(images), torch.from_numpy(targets), train=train,
        noise=jax_noise(key, jax_cfg, 6))
    assert_outputs_close(got, want)


@pytest.fixture(scope="module")
def shipped():
    """The shipped CNN checkpoint at full width, on 8 canvases of the
    serving fixture."""
    arch = jax_arch(CNN_CKPT)
    jax_cfg = JAX_DEFAULT.replace(**arch, st_impl="inline")
    with np.load(FIXTURE) as z:
        images = z["canvases"][:8]
    return jax_cfg, jax_load_params(CNN_CKPT), images


@pytest.mark.parametrize("train", [True, False])
def test_shipped_checkpoint_matches_jax(shipped, train):
    jax_cfg, jparams, images = shipped
    targets = np.array([0, 1, 2, 1, 0, 2, 1, 1], np.int32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, im, t, k: jax_forward(
        p, jax_cfg, im, t, k, train=train, step=0))(
        jparams, jnp.asarray(images), jnp.asarray(targets), key)
    cfg = DEFAULT_TRAINING_CONFIG.replace(**checkpoint_arch(CNN_CKPT),
                                          st_impl="inline")
    got = air_forward(params_from_jax(load_params(CNN_CKPT), "cpu"), cfg,
                      torch.from_numpy(images), torch.from_numpy(targets),
                      train=train, step=0, noise=jax_noise(key, jax_cfg, 8))
    assert_outputs_close(got, want)


def test_eval_step_matches_jax(shipped):
    """make_eval_step: train=False with the schedules resolved at step 0."""
    jax_cfg, jparams, images = shipped
    targets = np.zeros(8, np.int32)
    key = jax.random.PRNGKey(9)
    want = jax_eval_step(jax_cfg)(jparams, jnp.asarray(images),
                                  jnp.asarray(targets), key,
                                  jnp.zeros((), jnp.int32))
    cfg = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl="inline")
    got = make_eval_step(cfg)(params_from_jax(load_params(CNN_CKPT), "cpu"),
                              torch.from_numpy(images),
                              torch.from_numpy(targets), 0,
                              noise=jax_noise(key, jax_cfg, 8))
    assert_outputs_close(got, want)


@pytest.mark.parametrize("path", CKPTS, ids=os.path.basename)
def test_load_params_matches_jax(path):
    want = jax_load_params(path)
    got = load_params(path)
    w_leaves, w_tree = jax.tree_util.tree_flatten(want)
    g_leaves, g_tree = jax.tree_util.tree_flatten(got)
    assert g_tree == w_tree
    for g, w in zip(g_leaves, w_leaves):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert checkpoint_arch(path) == jax_arch(path)


def test_learn_background_canvas_init():
    """The canvas starts at sigmoid(params['background'])."""
    kw = {**SMALL, "learn_background": True, "st_impl": "xla"}
    jax_cfg = JaxConfig(**kw)
    params = init_air_params(jax.random.PRNGKey(2), jax_cfg)
    params["background"] = jnp.linspace(-3.0, 3.0, 400)
    images = np.random.default_rng(2).uniform(size=(3, 400)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    targets = np.zeros(3, np.int32)
    want = jax_forward(params, jax_cfg, jnp.asarray(images),
                       jnp.asarray(targets), key, train=True)
    got = air_forward(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        AIRConfig(**kw), torch.from_numpy(images),
        torch.from_numpy(targets), train=True,
        noise=jax_noise(key, jax_cfg, 3))
    assert_outputs_close(got, want)


def test_config_copy_matches_jax():
    """The port's own AIRConfig has the JAX package's fields and defaults."""
    import dataclasses
    j = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    t = {f.name: f.default for f in dataclasses.fields(AIRConfig)}
    assert t == j
    assert dataclasses.asdict(DEFAULT_TRAINING_CONFIG) == \
        dataclasses.asdict(JAX_DEFAULT)
    assert DEFAULT_TRAINING_CONFIG.schedules == JAX_DEFAULT.schedules
    assert DEFAULT_TRAINING_CONFIG.annealable_defaults() == \
        JAX_DEFAULT.annealable_defaults()
    for cnn in (True, False):
        assert (DEFAULT_TRAINING_CONFIG.replace(cnn=cnn).rnn_input_dim
                == JAX_DEFAULT.replace(cnn=cnn).rnn_input_dim)


@pytest.mark.parametrize("override", [{"st_pad_mode": "clamp_cancel"}])
def test_paths_of_later_slices_raise(override):
    """st_pad_mode="clamp_cancel" runs on st_impl="xla" (below); the
    kernels build the zeros-pad hat only, so "inline" and "pallas" raise
    ValueError, as the JAX package does."""
    for st_impl in ("inline", "pallas"):
        cfg = AIRConfig(**{**SMALL, **override, "st_impl": st_impl})
        images = torch.zeros((2, 400))
        with pytest.raises(ValueError, match="st_pad_mode"):
            air_forward({}, cfg, images, torch.zeros(2, dtype=torch.int32),
                        noise=draw_noise(cfg, 2, device="cpu"))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", ["scan", "stepparallel"])
def test_clamp_cancel_forward_matches_jax(layout, train, monkeypatch):
    """The clamped-corner transforms through the whole forward pass on
    st_impl="xla" in both decoder layouts, JAX given the port's grid (a
    grid point one ulp apart can move a clamped corner)."""
    jtr = importlib.import_module("air_tpu.ops.transformer")
    monkeypatch.setattr(jtr.jnp, "linspace", lambda start, stop, n:
                        jnp.asarray(_linspace(n, "cpu").numpy()))
    kw = {**SMALL, "st_impl": "xla", "st_pad_mode": "clamp_cancel",
          "decoder_layout": layout}
    jax_cfg = JaxConfig(**kw)
    params = init_air_params(jax.random.PRNGKey(2), jax_cfg)
    rng = np.random.default_rng(2)
    images = rng.uniform(size=(6, 400)).astype(np.float32)
    targets = np.array([0, 1, 2, 1, 0, 2], np.int32)
    key = jax.random.PRNGKey(3)
    want = jax_forward(params, jax_cfg, jnp.asarray(images),
                       jnp.asarray(targets), key, train=train)
    got = air_forward(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        AIRConfig(**kw), torch.from_numpy(images),
        torch.from_numpy(targets), train=train,
        noise=jax_noise(key, jax_cfg, 6))
    assert_outputs_close(got, want)


def test_generator_draws_are_reproducible():
    cfg = AIRConfig(**SMALL)
    a = draw_noise(cfg, 4, torch.Generator().manual_seed(5), "cpu")
    b = draw_noise(cfg, 4, torch.Generator().manual_seed(5), "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "scale": (2, 4, 1), "shift": (2, 4, 2), "vae_latent": (2, 4, 6),
        "vae_out": (2, 4, 64), "z_pres_u": (2, 4)}
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
