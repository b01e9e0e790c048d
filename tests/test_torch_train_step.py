"""One train step of the port (air_tpu_torch.train.steps.make_train_step)
against the JAX package's make_train_step from the same state, images and
draws (rebuilt from fold_in(state.key, step)), on the SMALL config and on
the shipped CNN checkpoint at full width, through st_impl "inline" and
"pallas" (the kernels' autograd Functions, their plain versions on the CPU)
and "xla".

Tolerances: metrics and updated parameters 1e-4 abs/rel, as the forward pass
(tests/test_torch_model.py): the frameworks reduce the LSTM product and the
BCE sums in other orders and XLA fuses multiply-adds. A gradient leaf is
held at 1e-4 times max(1, its largest magnitude): its entries are sums
whose rounding scales with their terms, not with the result, as the scalar
cotangents' are (tests/test_torch_st_inline.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.models.air import air_forward as jax_forward
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_DEFAULT
from air_tpu.train.checkpoint import load_params as jax_load_params
from air_tpu.train.state import create_train_state as jax_create
from air_tpu.train.steps import bg_intensity as jax_bg_intensity
from air_tpu.train.steps import make_train_step as jax_make_train_step
from air_tpu_torch.interop import opt_state_from_jax, params_from_jax
from air_tpu_torch.models.config import AIRConfig, DEFAULT_TRAINING_CONFIG
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import make_train_step
from air_tpu_torch.tree import tree_leaves, tree_leaves_with_path
from tests.test_torch_model import CNN_CKPT, FIXTURE, SMALL, jax_noise
from tests.test_torch_train import (LR_SCHEDULE, MAIN_OPT, _images,
                                    to_np)

TOL = dict(rtol=1e-4, atol=1e-4)


def leaves_close(got, want, tol=1e-4):
    """Every leaf within tol * max(1, max |leaf|); trees of the same paths."""
    g, w = tree_leaves_with_path(got), tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), (path, err)


def check_train_step(jcfg, cfg, jstate, images, targets, jax_step_kw=None,
                     step_kw=None):
    """One train step of each package from the same state, images and draws:
    gradients against jax.grad, the updated params and the metrics against
    the JAX step."""
    jax_step_kw, step_kw = jax_step_kw or {}, step_kw or {}
    step = int(jstate.step)
    key = jax.random.fold_in(jstate.key, step)
    jstep = jax_make_train_step(jcfg, donate=False, **jax_step_kw)
    jnew, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(targets))

    state = create_train_state(cfg, params=params_from_jax(
        to_np(jstate.params), "cpu"), device="cpu")
    state = state.replace(
        step=step,
        opt_state=opt_state_from_jax(
            to_np(jax.tree_util.tree_leaves(jstate.opt_state)),
            state.params, "cpu"))
    train_step = make_train_step(cfg, with_grad_stats=True, **step_kw)
    new, metrics = train_step(state, images, targets,
                              noise=jax_noise(key, jcfg, len(images)))

    bg = jax_step_kw.get("bg_image")
    jimages = jnp.asarray(images)
    if bg is not None:
        s = jax_bg_intensity(jax_step_kw["bg_schedule"], step)
        jimages = jnp.clip(jimages + s * jnp.asarray(bg)[None, :], 0.0, 1.0)

    def loss_fn(p):
        return jax_forward(p, jcfg, jimages, jnp.asarray(targets), key,
                           train=True, step=step).loss

    want_grads = params_from_jax(to_np(jax.grad(loss_fn)(jstate.params)),
                                 "cpu")
    leaves_close(metrics["grad_tensors"]["original"], want_grads)
    for a, b in zip(tree_leaves(new.params),
                    tree_leaves(params_from_jax(to_np(jnew.params), "cpu"))):
        torch.testing.assert_close(a, b, **TOL)
    assert new.step == int(jnew.step) == step + 1
    assert set(jmetrics) - {"grad_stats", "grad_tensors"} <= set(metrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), err_msg=k,
                                   **TOL)
    return new, metrics


@pytest.mark.parametrize("st_impl", ["inline", "pallas", "xla"])
def test_train_step_matches_jax_small(st_impl):
    kw = {**SMALL, **MAIN_OPT, "st_impl": st_impl}
    jcfg = JaxConfig(**kw)
    jstate = jax_create(jcfg, rng=0)
    images, targets = _images(6, SMALL["canvas_size"])
    new, metrics = check_train_step(jcfg, AIRConfig(**kw), jstate, images,
                                    targets)
    assert set(metrics["grad_stats"]) == {
        f"{'/'.join(map(str, p))}_grad_{w}_{s}"
        for p, _ in tree_leaves_with_path(new.params)
        for w in ("original", "applied") for s in ("norm", "avg")}


def test_train_step_matches_jax_with_background_composite():
    """bg_image composited at bg_intensity(step), annealed hyperparameters
    and a learning-rate schedule at a later global step (5)."""
    kw = {**SMALL, **MAIN_OPT, "learn_background": True,
          "annealing_schedules": {**LR_SCHEDULE,
                                  "z_pres_prior_log_odds": {
                                      "init": 100.0, "min": 1e-3,
                                      "factor": 0.5, "iters": 3,
                                      "log": True}}}
    jcfg = JaxConfig(**kw)
    jstate = jax_create(jcfg, rng=1)
    jstate = jstate.replace(step=jnp.asarray(5, jnp.int32))
    bg = np.random.default_rng(7).uniform(size=400).astype(np.float32)
    sched = {"target": 0.6, "start": 2, "ramp": 6}
    images, targets = _images(6, SMALL["canvas_size"], seed=2)
    _, metrics = check_train_step(
        jcfg, AIRConfig(**kw), jstate, images, targets,
        jax_step_kw=dict(bg_image=bg, bg_schedule=sched),
        step_kw=dict(bg_image=bg, bg_schedule=sched))
    assert float(metrics["bg_intensity"]) == pytest.approx(0.3)


@pytest.mark.parametrize("st_impl", ["inline", "pallas", "xla"])
def test_train_step_matches_jax_on_shipped_checkpoint(st_impl):
    """The main path's configuration at full width (CNN, LSTM 256, VAE
    (512,256)->50->(256,512), bf16 Adam moments, clip 1.0, lr 1e-4), from
    the shipped CNN checkpoint, on 8 fixture canvases."""
    jcfg = JAX_DEFAULT.replace(cnn=True, st_impl=st_impl)
    jstate = jax_create(jcfg, rng=0, params=jax_load_params(CNN_CKPT))
    with np.load(FIXTURE) as z:
        images, targets = z["canvases"][:8], z["digits"][:8]
    check_train_step(jcfg, DEFAULT_TRAINING_CONFIG.replace(
        cnn=True, st_impl=st_impl), jstate, images, targets)
