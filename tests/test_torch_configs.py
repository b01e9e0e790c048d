"""The JAX package's two other BASELINE configurations (BASELINE.json
"configs" 3 and 4, ``bench.py:get_config``) in the port, against the JAX
package on the CPU, at narrow widths and the configurations' own shapes:

  * harder: 5 attention steps, max 3 digits, a learned background, on the
    50x50 canvas with the 28x28 window;
  * scaled: the 100x100 canvas with the 28x28 window and a VAE latent of
    100 (the LSTM and the MLPs narrow); the gradients in float64 and the
    model axis at its full widths.

Held: ``air_forward`` at T = 5 in both decoder layouts (1e-4 abs/rel,
digit counts exact: tests/test_torch_model.py's bars), the train step's
gradients and loss at canvas 100 and at T = 5 (a gradient leaf to 1e-4 x
max(1, its largest), tests/test_torch_train_step.py's bar), the
gradients in float64 from a data-like background at T = 5 and at the
scaled configuration's full widths (1e-6 x max(1, its largest)),
``summarize_outputs`` at max_digits 3 (1e-6), the harder set's
background estimate (bits), ``param_shapes`` against an init's shapes,
and data 2 x model 2 at the scaled shapes against the single-process
step (tests/test_parallel.py's bars: the loss to rtol 1e-5, the params
to 1e-4; the gradients to 5e-5 relative, tests/test_torch_parallel.py's).
JAX's Pallas kernels run in interpret mode, as the JAX package's own
tests run them. The plain versions of kernels 1-7 meet JAX's kernels at
(100, 28) in the (3, 100, 28) cases of tests/test_torch_st_*.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.data import backgrounds as jax_bg
from air_tpu.data import mnist as jax_mnist
from air_tpu.data import multi_mnist as jax_mm
from air_tpu.models.air import air_forward as jax_forward
from air_tpu.models.air import init_air_params as jax_init
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.train.metrics import summarize_outputs as jax_summarize
from air_tpu_torch.data import backgrounds, multi_mnist
from air_tpu_torch.interop import params_from_jax, params_to_jax
from air_tpu_torch.models.air import air_forward, init_air_params
from air_tpu_torch.models.config import AIRConfig, DEFAULT_TRAINING_CONFIG
from air_tpu_torch.parallel.launch import launch
from air_tpu_torch.parallel.mesh import param_shapes
from air_tpu_torch.train.metrics import summarize_outputs
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import make_train_step
from air_tpu_torch.tree import (tree_leaves, tree_leaves_with_path,
                                tree_map, tree_unflatten)
from tests import torch_configs_ranks as ranks
from tests.test_torch_model import SMALL, assert_outputs_close, jax_noise
from tests.test_torch_train import MAIN_OPT, _images, to_np
from tests.test_torch_train_step import leaves_close

HARDER = {**SMALL, "max_steps": 5, "max_digits": 3, "canvas_size": 50,
          "windows_size": 28, "learn_background": True}
SCALED = {**SMALL, "canvas_size": 100, "windows_size": 28,
          "vae_latent_dimensions": 100}
# BASELINE config 4 at its full widths (bench.py:get_config("scaled"))
FULL_SCALED = dataclasses.asdict(DEFAULT_TRAINING_CONFIG.replace(
    canvas_size=100, rnn_units=512, vae_latent_dimensions=100))


def _background(n: int) -> np.ndarray:
    """A learned background as ``--bg-init data`` starts it on the bg-0.6
    noise set: the logit of a pixel estimate clipped to [1e-3, 0.6] (a ramp
    over the canvas)."""
    bg = np.linspace(1e-3, 0.6, n).astype(np.float32)
    return np.log(bg) - np.log1p(-bg)


def _case(kw, seed, batch, targets):
    """(JAX config, port config, numpy params, images, targets)."""
    jcfg = JaxConfig(**kw)
    params = to_np(jax_init(jax.random.PRNGKey(seed), jcfg))
    if kw.get("learn_background"):
        params["background"] = _background(kw["canvas_size"] ** 2)
    images, _ = _images(batch, kw["canvas_size"], seed=seed)
    return jcfg, AIRConfig(**kw), params, images, np.asarray(targets,
                                                             np.int32)


def both(jcfg, cfg, params, images, targets, key, train):
    """(port outputs, JAX outputs) on the same params and draws; JAX's
    forward compiled (tests/test_torch_layouts.py runs it op by op)."""
    want = jax.jit(lambda p, im, t, k: jax_forward(
        p, jcfg, im, t, k, train=train))(
        params, jnp.asarray(images), jnp.asarray(targets), key)
    got = air_forward(params_from_jax(params, "cpu"), cfg,
                      torch.from_numpy(images), torch.from_numpy(targets),
                      train=train, noise=jax_noise(key, jcfg, len(images)))
    return got, want


# --- the forward pass at T = 5, max 3 digits, a learned background ----------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", ["scan", "stepparallel"])
def test_harder_forward_matches_jax(layout, train):
    """The scan layout through the inline kernels' plain versions (JAX: its
    inline kernels in interpret mode); the step-parallel one through the
    plain products, its only path."""
    st_impl = "inline" if layout == "scan" else "xla"
    case = _case({**HARDER, "decoder_layout": layout, "st_impl": st_impl},
                 seed=1, batch=6, targets=[0, 1, 2, 3, 2, 3])
    got, want = both(*case, jax.random.PRNGKey(2), train)
    assert got.rec_num_digits.shape == (6,)
    assert_outputs_close(got, want)


def test_scaled_forward_matches_jax():
    """Canvas 100 (CNN features 25 x 25 x 8 = 5,000), latent 100, through
    the inline kernels' plain versions."""
    case = _case(SCALED, seed=3, batch=4, targets=[0, 1, 2, 1])
    got, want = both(*case, jax.random.PRNGKey(4), True)
    assert got.rec_num_digits.shape == (4,)
    assert_outputs_close(got, want)


# --- one train step ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    SCALED, {**SCALED, "st_impl": "pallas"}, HARDER,
    {**HARDER, "decoder_layout": "stepparallel", "st_impl": "xla"}],
    ids=["scaled-inline", "scaled-pallas", "harder-inline",
         "harder-stepparallel"])
def test_train_step_gradients_match_jax(kw):
    """The gradients of the port's train step (make_train_step, bf16 Adam
    moments, clip 1.0) against jax.grad of JAX's air_forward at the same
    params (JAX's init: a learned background at -4) and draws, every leaf
    to 1e-4 x max(1, its largest), and the loss to 1e-4. JAX takes its
    plain path: its kernels meet the port's plain versions at canvas 100
    in the (3, 100, 28) cases of tests/test_torch_st_*.py. (The
    optimizer's update is held in tests/test_torch_train.py.)

    Two cases hold only in float64 (test_gradients_match_jax_in_float64):
    the harder configuration from a background near the data's, and the
    scaled one at its full widths. There float32 rounding alone moves
    every leaf by more than 1e-4 of its largest, in either package."""
    kw = {**kw, **MAIN_OPT}
    jcfg = JaxConfig(**{**kw, "st_impl": "xla"})
    params = jax_init(jax.random.PRNGKey(5), jcfg)
    images, targets = _images(4, kw["canvas_size"], seed=6)
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jax_forward(p, jcfg, jnp.asarray(images),
                           jnp.asarray(targets), key, train=True,
                           step=0).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    cfg = AIRConfig(**kw)
    state = create_train_state(cfg, params=params_from_jax(to_np(params),
                                                           "cpu"),
                               device="cpu")
    _, metrics = make_train_step(cfg, with_grad_stats=True)(
        state, images, targets, noise=jax_noise(key, jcfg, 4))
    leaves_close(metrics["grad_tensors"]["original"],
                 params_from_jax(to_np(grads), "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture
def float64(monkeypatch):
    """Both packages in float64: JAX with x64 on, and in both the name
    float32, with which each package states its working precision, bound
    to float64 for the test."""
    monkeypatch.setattr(jnp, "float32", jnp.float64)
    monkeypatch.setattr(torch, "float32", torch.float64)
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("kw", [HARDER, FULL_SCALED],
                         ids=["harder-data-background", "scaled-full-width"])
def test_gradients_match_jax_in_float64(kw, float64):
    """The gradients of the loss in float64, the port's air_forward under
    autograd against jax.grad of JAX's, from the same params and draws on
    the plain path: every leaf to 1e-6 x max(1, its largest) and the loss
    to 1e-12. The two cases where float32 does not meet 1e-4: the harder
    configuration from a background like --bg-init data's (sigmoid up to
    0.6; five writes take some pixels within 1e-4 of 1, and the BCE's
    (1 - t) / (1 - x + 1e-9) magnifies an ulp of x there), and the scaled
    configuration at its full widths (LSTM 512, latent 100, the CNN, batch
    4). That the gap falls with the rounding shows it is rounding, not a
    difference in the algebra."""
    kw = {**kw, **MAIN_OPT, "st_impl": "xla"}
    jcfg = JaxConfig(**kw)
    object.__setattr__(jcfg, "compute_dtype", "float64")   # past validation
    cfg = AIRConfig(**kw)
    params = params_to_jax(init_air_params(torch.Generator().manual_seed(5),
                                           cfg))
    if kw["learn_background"]:
        params["background"] = _background(kw["canvas_size"] ** 2)
    # float32 values (the port's params_from_jax takes float32), in float64
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32).astype(np.float64), params)
    images, targets = _images(4, kw["canvas_size"], seed=6)
    images = images.astype(np.float64)
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jax_forward(p, jcfg, jnp.asarray(images), jnp.asarray(targets),
                           key, train=True, step=0).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tparams = tree_map(lambda t: t.double().requires_grad_(True),
                       params_from_jax(params, "cpu"))
    out = air_forward(tparams, cfg, torch.from_numpy(images),
                      torch.from_numpy(targets), train=True,
                      noise=jax_noise(key, jcfg, 4), step=0)
    assert out.loss.dtype == torch.float64
    got = params_to_jax(tree_unflatten(tparams, torch.autograd.grad(
        out.loss, tree_leaves(tparams))))          # in JAX's layout
    leaves_close(tree_map(torch.from_numpy, got),
                 tree_map(torch.from_numpy, to_np(grads)), tol=1e-6)
    np.testing.assert_allclose(float(out.loss), float(loss), rtol=1e-12)


# --- eval summaries, data ---------------------------------------------------

def test_summarize_outputs_matches_jax_at_max_digits_3():
    """Four digit-count buckets and five steps: the same keys and values
    from the same outputs, NaN where a slice is empty."""
    jcfg, _, params, images, targets = _case(
        {**HARDER, "st_impl": "xla"}, seed=7, batch=9,
        targets=[0, 1, 2, 3, 3, 1, 0, 2, 3])
    out = jax.jit(lambda p, im, t, k: jax_forward(p, jcfg, im, t, k,
                                                  train=False))(
        params, jnp.asarray(images), jnp.asarray(targets),
        jax.random.PRNGKey(8))
    want = jax_summarize(out, jnp.asarray(targets), 5, 3)
    got = summarize_outputs(
        type(out)(*(torch.from_numpy(np.array(v)) for v in out)),
        torch.from_numpy(targets), 5, 3)
    assert set(got) == set(want)
    assert {"digit_acc_3_dig", "scale_5_step_3_dig"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_harder_background_estimate_matches_jax():
    """``--bg-init data`` on a set of 0-3 digits on the bg-0.6 noise
    texture: the 0-digit mean and, without 0-digit scenes, the per-pixel
    minimum, bit for bit."""
    pool, labels = jax_mnist.synthesize_mnist(n=60, seed=0)
    kw = dict(max_digits=3, max_in_common=3, images_per_digit=6,
              test_set_size=4, bg_kind="noise", bg_max_intensity=0.6, seed=1)
    got = multi_mnist.generate_dataset(pool, labels,
                                       multi_mnist.MultiMNISTConfig(**kw))
    want = jax_mm.generate_dataset(pool, labels, jax_mm.MultiMNISTConfig(**kw))
    images = np.stack(got["common"]["images"]).reshape(20, -1)
    digits = np.asarray(got["common"]["digits"])
    np.testing.assert_array_equal(
        images, np.stack(want["common"]["images"]).reshape(20, -1))
    assert set(digits) == {0, 1, 2, 3}
    for d in (digits, None):
        np.testing.assert_array_equal(
            backgrounds.estimate_background(images, d),
            jax_bg.estimate_background(images, d))
    some = digits > 0
    np.testing.assert_array_equal(
        backgrounds.estimate_background(images[some], digits[some]),
        jax_bg.estimate_background(images[some], digits[some]))


# --- the model axis at the scaled shapes ------------------------------------

@pytest.mark.parametrize("kw", [SCALED, {**HARDER, "cnn": False}],
                         ids=["scaled", "harder-raw-pixel"])
def test_param_shapes_are_an_inits(kw):
    """``param_shapes`` (what ``param_sharding`` places, on the meta
    device) gives the paths, shapes and dtypes of an init, leaf for leaf."""
    cfg = AIRConfig(**kw)
    want = init_air_params(torch.Generator().manual_seed(0), cfg)
    got = param_shapes(cfg)
    assert [(p, t.shape, t.dtype, t.is_meta)
            for p, t in tree_leaves_with_path(got)] == [
        (p, t.shape, t.dtype, True) for p, t in tree_leaves_with_path(want)]


def test_model_axis_scaled_shapes():
    """Data 2 x model 2 (gloo ranks on the CPU) at the scaled model's full
    shapes without the CNN (tests/test_parallel.py:160-193): the
    (10,512, 2048) LSTM gate kernel held as 1,024 columns a rank, 6 or more
    leaves sharded, the layout kept through one step, and that step against
    the single-process step on the whole batch of 16 with the same draws."""
    cfg = DEFAULT_TRAINING_CONFIG.replace(
        canvas_size=100, rnn_units=512, vae_latent_dimensions=100, cnn=False)
    results = launch(ranks.world4_scaled, "gloo", ["cpu"] * 4, (cfg, 16),
                     timeout=300)
    for out in results:
        assert sum(p is not None for p in out["placed"]) >= 6
        for layout in ("before", "after", "mu"):
            assert out[layout]["lstm/kernel"] == (10512, 1024), layout
        assert out["before"] == out["after"]
        np.testing.assert_allclose(*out["loss"], rtol=1e-5)
        for kind, err in out["grads"].items():
            assert err < 5e-5, (kind, err)
        assert out["params"] < 1e-4
