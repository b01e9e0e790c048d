"""The port's decoder layouts and options (air_tpu_torch.models.air): the
step-parallel decoder, the hoisted LSTM input and bfloat16 compute, each
against the JAX package's air_forward and make_train_step with the same
params and draws (the noise rebuilt from JAX's key tree), and the
step-parallel layout against the port's own scan layout.

Tolerances:
  * port vs JAX, float32: 1e-4 abs/rel on every output and train-step
    metric, a gradient leaf 1e-4 x max(1, its largest magnitude)
    (tests/test_torch_model.py, tests/test_torch_train_step.py); digit
    counts exact.
  * port step-parallel vs port scan: 2e-5 abs/rel on every output, relative
    L2 < 1e-3 on every gradient leaf, the JAX package's own bars for its
    two layouts (tests/test_model.py:245-283).
  * bfloat16: the loss within rtol 1e-2 of JAX's bfloat16 loss and digit
    counts exact. Each framework rounds its own bfloat16 intermediates
    (8 significant bits, 2^-9 relative per rounding), and the raw-pixel
    encoder's eps-guarded BCE magnifies a moved window. Measured on the CPU
    over 3 seeds: at most 1.7e-5 with the CNN and 3.3e-3 with raw pixels
    (SMALL, train), 1.2e-3 / 5.3e-4 at the CNN / raw-pixel checkpoints'
    full width. Against the port's float32 loss: rtol 2e-2, the JAX
    package's bar (tests/test_precision.py:149-171).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from air_tpu.models.air import air_forward as jax_forward
from air_tpu.models.air import init_air_params as jax_init
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_DEFAULT
from air_tpu.train.checkpoint import load_params as jax_load_params
from air_tpu.train.state import create_train_state as jax_create
from air_tpu_torch.interop import params_from_jax
from air_tpu_torch.models.air import AIRModel, air_forward, draw_noise
from air_tpu_torch.models.config import AIRConfig, DEFAULT_TRAINING_CONFIG
from air_tpu_torch.train.checkpoint import checkpoint_arch
from air_tpu_torch.tree import tree_leaves, tree_leaves_with_path
from tests.test_torch_model import (CKPTS, CNN_CKPT, FIXTURE, SMALL,
                                    assert_outputs_close, jax_noise)
from tests.test_torch_train import MAIN_OPT, _images, to_np
from tests.test_torch_train_step import check_train_step

SP = "stepparallel"
BF16_LOSS_RTOL = 1e-2


def small_case(seed=0, **over):
    """(JAX config, port config, numpy params, images, targets) at SMALL."""
    kw = {**SMALL, "st_impl": "xla", **over}
    jcfg = JaxConfig(**kw)
    params = to_np(jax_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(6, 400)).astype(np.float32)
    targets = np.array([0, 1, 2, 1, 0, 2], np.int32)
    return jcfg, AIRConfig(**kw), params, images, targets


def both(jcfg, cfg, params, images, targets, key, train):
    """(port outputs, JAX outputs) on the same params and draws."""
    want = jax_forward(params, jcfg, jnp.asarray(images),
                       jnp.asarray(targets), key, train=train)
    got = air_forward(params_from_jax(params, "cpu"), cfg,
                      torch.from_numpy(images), torch.from_numpy(targets),
                      train=train, noise=jax_noise(key, jcfg, len(images)))
    return got, want


def shipped_case(path, **over):
    """The checkpoint at full width on 8 fixture canvases."""
    arch = checkpoint_arch(path)
    jcfg = JAX_DEFAULT.replace(**arch, **over)
    cfg = DEFAULT_TRAINING_CONFIG.replace(**arch, **over)
    with np.load(FIXTURE) as z:
        images, targets = z["canvases"][:8], z["digits"][:8]
    return jcfg, cfg, to_np(jax_load_params(path)), images, targets


def port_grads(cfg, params, images, targets, noise):
    """(outputs, {path: gradient of the loss}) of the port's forward."""
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    out = air_forward(params, cfg, torch.from_numpy(images),
                      torch.from_numpy(targets), train=True, noise=noise)
    grads = torch.autograd.grad(out.loss, leaves)
    return out, dict(zip([p for p, _ in tree_leaves_with_path(params)],
                         grads))


# --- step-parallel and hoisted forwards against JAX --------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("over", [
    {"decoder_layout": SP}, {"decoder_layout": SP, "rnn_input_hoist": True},
    {"rnn_input_hoist": True}, {"rnn_input_hoist": True, "st_impl": "inline"},
    {"decoder_layout": SP, "cnn": False}], ids=str)
def test_forward_matches_jax(over, train):
    """The scan + hoist case with st_impl="inline" gives JAX its inline
    kernels (interpret mode) and the port its kernels' plain versions."""
    case = small_case(**over)
    got, want = both(*case, jax.random.PRNGKey(1), train)
    assert_outputs_close(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_stepparallel_cnn_and_learned_background_match_jax(train):
    """The background enters the canvas once, after the sum over the
    steps, as the JAX package's step-parallel decoder adds it."""
    jcfg, cfg, params, images, targets = small_case(
        seed=4, decoder_layout=SP, learn_background=True)
    params["background"] = np.linspace(-3.0, 3.0, 400).astype(np.float32)
    got, want = both(jcfg, cfg, params, images, targets,
                     jax.random.PRNGKey(6), train)
    assert_outputs_close(got, want)


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: p.split("/")[-1])
@pytest.mark.parametrize("over", [
    {"decoder_layout": SP}, {"decoder_layout": SP, "rnn_input_hoist": True}],
    ids=str)
def test_shipped_checkpoints_match_jax(path, over):
    """Full width: LSTM 256, VAE (512,256)->50->(256,512), canvas 50,
    window 28, 3 steps; the CNN and the raw-pixel encoder."""
    jcfg, cfg, params, images, targets = shipped_case(path, **over)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, im, t, k: jax_forward(
        p, jcfg, im, t, k, train=False, step=0))(
        params, jnp.asarray(images), jnp.asarray(targets), key)
    got = air_forward(params_from_jax(params, "cpu"), cfg,
                      torch.from_numpy(images), torch.from_numpy(targets),
                      train=False, step=0, noise=jax_noise(key, jcfg, 8))
    assert_outputs_close(got, want)


# --- the step-parallel train step --------------------------------------------

@pytest.mark.parametrize("over", [
    {}, {"rnn_input_hoist": True}, {"learn_background": True}], ids=str)
def test_stepparallel_train_step_matches_jax(over):
    """Gradients against jax.grad, the updated params and the metrics
    against JAX's make_train_step, from the same state and draws."""
    kw = {**SMALL, **MAIN_OPT, "st_impl": "xla", "decoder_layout": SP,
          **over}
    jcfg = JaxConfig(**kw)
    images, targets = _images(6, SMALL["canvas_size"], seed=3)
    check_train_step(jcfg, AIRConfig(**kw), jax_create(jcfg, rng=2), images,
                     targets)


def test_stepparallel_train_step_matches_jax_on_shipped_checkpoint():
    jcfg = JAX_DEFAULT.replace(cnn=True, decoder_layout=SP)
    jstate = jax_create(jcfg, rng=0, params=jax_load_params(CNN_CKPT))
    with np.load(FIXTURE) as z:
        images, targets = z["canvases"][:8], z["digits"][:8]
    check_train_step(jcfg, DEFAULT_TRAINING_CONFIG.replace(
        cnn=True, decoder_layout=SP), jstate, images, targets)


# --- step-parallel against the port's scan layout ----------------------------

@pytest.mark.parametrize("over", [
    {}, {"learn_background": True}, {"cnn": False}, {"rnn_input_hoist": True}],
    ids=str)
def test_stepparallel_matches_scan(over):
    """Outputs at 2e-5 in train and eval mode, gradients at relative L2
    < 1e-3: the draws are the same, only the products' row counts and the
    sums' order differ."""
    _, cfg, params, images, targets = small_case(seed=5, **over)
    sp = cfg.replace(decoder_layout=SP)
    noise = draw_noise(cfg, 6, torch.Generator().manual_seed(8), "cpu")
    for train in (True, False):
        outs = [air_forward(params_from_jax(params, "cpu"), c,
                            torch.from_numpy(images),
                            torch.from_numpy(targets), train=train,
                            noise=noise) for c in (cfg, sp)]
        assert torch.equal(outs[0].rec_num_digits, outs[1].rec_num_digits)
        for f in outs[0]._fields:
            torch.testing.assert_close(getattr(outs[1], f),
                                       getattr(outs[0], f), rtol=2e-5,
                                       atol=2e-5, msg=f)
    g_scan = port_grads(cfg, params_from_jax(params, "cpu"), images,
                        targets, noise)[1]
    g_sp = port_grads(sp, params_from_jax(params, "cpu"), images, targets,
                      noise)[1]
    for path, want in g_scan.items():
        got = g_sp[path].double()
        err = float(torch.linalg.norm(got - want.double())
                    / (torch.linalg.norm(want.double()) + 1e-12))
        assert err < 1e-3, (path, err)


@pytest.mark.parametrize("st_impl", ["inline", "pallas"])
def test_stepparallel_refuses_the_kernel_paths(st_impl):
    _, cfg, params, images, targets = small_case()
    cfg = cfg.replace(decoder_layout=SP, st_impl=st_impl)
    with pytest.raises(ValueError, match="stepparallel"):
        air_forward(params_from_jax(params, "cpu"), cfg,
                    torch.from_numpy(images), torch.from_numpy(targets),
                    noise=draw_noise(cfg, 6, device="cpu"))


# --- bfloat16 compute --------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("over", [
    {}, {"decoder_layout": SP}, {"rnn_input_hoist": True},
    {"cnn": False}, {"st_impl": "inline"}], ids=str)
def test_bfloat16_matches_jax(over, train):
    case = small_case(compute_dtype="bfloat16", **over)
    got, want = both(*case, jax.random.PRNGKey(1), train)
    np.testing.assert_array_equal(got.rec_num_digits.numpy(),
                                  np.asarray(want.rec_num_digits))
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=BF16_LOSS_RTOL)
    for f in got._fields:
        assert getattr(got, f).dtype in (torch.float32, torch.int32), f


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: p.split("/")[-1])
@pytest.mark.parametrize("layout", ["scan", SP])
def test_bfloat16_shipped_checkpoints_match_jax(path, layout):
    jcfg, cfg, params, images, targets = shipped_case(
        path, compute_dtype="bfloat16", decoder_layout=layout)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, im, t, k: jax_forward(
        p, jcfg, im, t, k, train=False, step=0))(
        params, jnp.asarray(images), jnp.asarray(targets), key)
    got = air_forward(params_from_jax(params, "cpu"), cfg,
                      torch.from_numpy(images), torch.from_numpy(targets),
                      train=False, step=0, noise=jax_noise(key, jcfg, 8))
    np.testing.assert_array_equal(got.rec_num_digits.numpy(),
                                  np.asarray(want.rec_num_digits))
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("over", [
    {}, {"decoder_layout": SP}, {"rnn_input_hoist": True}, {"cnn": False},
    {"learn_background": True}], ids=str)
def test_bfloat16_against_float32(over):
    """Loss within rtol 2e-2 of the float32 loss; every gradient leaf
    float32, finite and nonzero (float32 master params)."""
    _, cfg, params, images, targets = small_case(seed=1, **over)
    noise = draw_noise(cfg, 6, torch.Generator().manual_seed(2), "cpu")
    out32 = air_forward(params_from_jax(params, "cpu"), cfg,
                        torch.from_numpy(images), torch.from_numpy(targets),
                        train=True, noise=noise)
    out16, grads = port_grads(cfg.replace(compute_dtype="bfloat16"),
                              params_from_jax(params, "cpu"), images,
                              targets, noise)
    np.testing.assert_allclose(float(out16.loss.detach()), float(out32.loss),
                               rtol=2e-2)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        assert bool(torch.isfinite(g).all()), path
        assert bool((g != 0).any()), path


def _uses_of_casts(loss, leaf):
    """The autograd edges that carry a cotangent of a bfloat16 copy of
    ``leaf``: [(node, input index)] of every node fed by a cast node whose
    own input is ``leaf``. Walks the graph from ``loss``."""
    casts, feeds, seen, stack = set(), [], set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for i, (nxt, _) in enumerate(node.next_functions):
            if nxt is None:
                continue
            if getattr(nxt, "variable", None) is leaf and \
                    type(node).__name__ == "ToCopyBackward0":
                casts.add(node)
            feeds.append((node, i, nxt))
            stack.append(nxt)
    return casts, [(n, i) for n, i, nxt in feeds if nxt in casts]


@pytest.mark.parametrize("over", [
    {}, {"decoder_layout": SP}, {"rnn_input_hoist": True}], ids=str)
def test_bfloat16_steps_sum_their_cotangents_in_float32(over):
    """Each step's bfloat16 cotangent of a parameter is converted to float32
    on its own, and the sum over the steps is float32: the gradient of each
    LSTM and head leaf equals the float64 sum of the bfloat16 cotangents
    that reach its casts, to float32 rounding (1e-5 of its largest
    magnitude). A cast made once before the steps and used by all of them
    sums the steps' cotangents in bfloat16 first. Measured on these cases
    (max abs error over max abs): the per-step casts part a leaf from the
    sum by at most 2.4e-11; a variant that casts once and reuses the cast
    in every step parts the LSTM kernel's gradient by 1.6e-3 (scan) and
    3.0e-3 (step-parallel), and a head's by 1.5e-3 (hoisted input)."""
    _, cfg, params, images, targets = small_case(
        seed=2, compute_dtype="bfloat16", **over)
    params = params_from_jax(params, "cpu")
    noise = draw_noise(cfg, 6, torch.Generator().manual_seed(3), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    out = air_forward(params, cfg, torch.from_numpy(images),
                      torch.from_numpy(targets), train=True, noise=noise)
    checked = [params["lstm"]["kernel"], params["lstm"]["bias"],
               params["scale_mean"]["hidden"]["w"],
               params["z_pres_log_odds"]["out"]["w"]]
    captured = {id(leaf): [] for leaf in checked}
    handles = []
    for leaf in checked:
        casts, uses = _uses_of_casts(out.loss, leaf)
        assert casts, "no bfloat16 cast of the leaf"
        for node, i in uses:
            def hook(grad_inputs, grad_outputs, i=i, box=captured[id(leaf)]):
                box.append(grad_inputs[i].detach().double())
            handles.append(node.register_hook(hook))
    grads = torch.autograd.grad(out.loss, leaves)
    for h in handles:
        h.remove()
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    for leaf in checked:
        parts = captured[id(leaf)]
        assert parts and all(p.shape == leaf.shape for p in parts)
        want = torch.stack(parts).sum(0)
        err = float((by_id[id(leaf)].double() - want).abs().max()
                    / want.abs().max())
        assert err < 1e-5, (leaf.shape, err, len(parts))


# --- the facade --------------------------------------------------------------

def test_air_model_facade():
    """AIRModel: the JAX package's facade, with the port's draws."""
    model = AIRModel(AIRConfig(**SMALL), rng=0, device="cpu",
                     decoder_layout=SP, st_impl="xla")
    assert model.config.decoder_layout == SP
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jax_init(jax.random.PRNGKey(0), JaxConfig(**SMALL))))
    assert model.num_params == n
    images = torch.rand((4, 400), generator=torch.Generator().manual_seed(0))
    targets = torch.zeros(4, dtype=torch.int32)
    a = model(images, targets, generator=torch.Generator().manual_seed(1))
    b = air_forward(model.params, model.config, images, targets,
                    generator=torch.Generator().manual_seed(1))
    assert a.rec_windows.shape == (4, 2, 64)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if not torch.cuda.is_available():
        # no silent CPU fallback: the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            AIRModel(AIRConfig(**SMALL))
