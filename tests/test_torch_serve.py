"""The port's serving facade (air_tpu_torch.serve.model_wrapper) on the
shipped checkpoints, held against the JAX package's ModelWrapper, and
the committed serving fixture held against the JAX package's generator.

Tolerance of the served outputs against the JAX wrapper's, given JAX's
draws: 1e-4 abs/rel, as the forward pass (tests/test_torch_model.py);
digit counts exactly."""

import os

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py pins it)
import numpy as np
import pytest
import torch

from air_tpu.data import MultiMNISTConfig, generate_dataset, get_mnist
from air_tpu.models.air import init_air_params as jax_init
from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_CFG
from air_tpu.serve.model_wrapper import ModelWrapper as JaxWrapper
from air_tpu.train.checkpoint import load_params as jax_load_params
from air_tpu_torch.kernels import st_fused, st_inline, st_pallas
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG as CFG
from air_tpu_torch.serve.model_wrapper import ModelWrapper
from air_tpu_torch.train.checkpoint import checkpoint_arch, load_params
from tests.test_model import SMALL as JAX_SMALL
from tests.test_torch_model import jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")


def make_serve_canvases():
    """The 60 test canvases of tests/test_shipped_model.py's CNN check:
    (canvases [60, 2500] float32, digit counts [60] int32)."""
    digits, labels, _ = get_mnist("/nonexistent-dir", n_synthetic=300, seed=11)
    data = generate_dataset(
        digits, labels,
        MultiMNISTConfig(max_digits=2, max_in_common=2, images_per_digit=40,
                         test_set_size=60, canvas_size=50, seed=11),
        out_dir=None)
    return (np.asarray(data["test"]["images"], np.float32).reshape(-1, 2500),
            np.asarray(data["test"]["digits"], np.int32))


def write_fixture(path=FIXTURE):
    canvases, digits = make_serve_canvases()
    np.savez_compressed(path, canvases=canvases, digits=digits)


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return z["canvases"], z["digits"]


@pytest.fixture(scope="module")
def config():
    return CFG.replace(**checkpoint_arch(CNN_CKPT), st_impl="inline")


@pytest.fixture(scope="module")
def wrapper(config):
    return ModelWrapper(config, load_params(CNN_CKPT), seed=0, device="cpu")


def test_fixture_matches_generator(fixture):
    canvases, digits = make_serve_canvases()
    np.testing.assert_array_equal(fixture[0], canvases)
    np.testing.assert_array_equal(fixture[1], digits)
    assert fixture[0].shape == (60, 2500) and fixture[0].dtype == np.float32


def test_infer_counts_digits(wrapper, fixture):
    """The bar of tests/test_shipped_model.py's CNN check: >= 0.9."""
    canvases, truth = fixture
    st_inline.reset_launches()
    digits = wrapper.infer(canvases)[0]
    acc = float(np.mean(np.asarray(digits) == truth))
    assert acc >= 0.9, f"port's shipped CNN checkpoint accuracy {acc}"
    # on CPU tensors the wrappers take the plain versions: no launch
    assert st_inline.LAUNCHES == {"inline_attention_read": 0,
                                  "inline_write_accumulate": 0,
                                  "inline_attention_read_bwd": 0,
                                  "inline_write_accumulate_bwd": 0}


@pytest.mark.parametrize("n", [1, 5, 60])
def test_infer_structure_matches_jax(wrapper, fixture, n):
    """Same structure, types and lengths as the JAX wrapper's returns. The
    two draw different noise, so each item is checked against its own
    digit count."""
    jax_wrapper = JaxWrapper(
        JAX_CFG.replace(cnn=True, st_impl="inline"),
        jax_load_params(CNN_CKPT))
    images = fixture[0][:n]
    got, want = wrapper.infer(images), jax_wrapper.infer(images)
    assert len(got) == len(want) == 6
    for g_list, w_list in zip(got, want):
        assert type(g_list) is type(w_list) and len(g_list) == len(w_list) == n
    ws, L = 28, 50
    for i in range(n):
        for out in (got, want):
            d = out[0][i]
            assert isinstance(d, int)
            assert out[1][i].shape == ((d, 3) if d else (0,))
            assert out[2][i].shape == (50, 50)
            assert out[3][i].shape == ((d, ws, ws) if d else (0,))
            assert out[4][i].shape == ((d, L) if d else (0,))
        for k in (1, 2, 3, 4, 5):
            assert type(got[k][i]) is type(want[k][i])
            assert np.asarray(got[k][i]).dtype == np.asarray(want[k][i]).dtype


def test_pallas_infer_counts_digits(config, fixture):
    """st_impl="pallas" serves the checkpoint at the same bar, through the
    streamed-weight Functions (their plain versions on the CPU)."""
    canvases, truth = fixture
    wrapper = ModelWrapper(config.replace(st_impl="pallas"),
                           load_params(CNN_CKPT), seed=0, device="cpu")
    st_pallas.reset_launches()
    st_fused.reset_launches()
    digits = wrapper.infer(canvases)[0]
    acc = float(np.mean(np.asarray(digits) == truth))
    assert acc >= 0.9, f"port's shipped CNN checkpoint accuracy {acc}"
    assert set(st_pallas.LAUNCHES.values()) == {0}
    assert set(st_fused.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("n", [1, 8, 60])
def test_pallas_infer_matches_jax(config, fixture, n):
    """The port's wrapper with st_impl="pallas", given the draws of the JAX
    wrapper's call (fold_in(PRNGKey(seed), call)), returns the JAX
    wrapper's answers: padding, forward through the streamed-weight
    kernels' Functions, packing and trimming."""
    jax_cfg = JAX_CFG.replace(cnn=True, st_impl="pallas")
    jax_wrapper = JaxWrapper(jax_cfg, jax_load_params(CNN_CKPT), seed=4)
    wrapper = ModelWrapper(config.replace(st_impl="pallas"),
                           load_params(CNN_CKPT), seed=4, device="cpu")
    forward = wrapper._eval
    calls = []

    def with_jax_draws(params, images, targets, step, generator=None):
        calls.append(step)
        key = jax.random.fold_in(jax.random.PRNGKey(4), len(calls))
        return forward(params, images, targets, step,
                       noise=jax_noise(key, jax_cfg, len(images)))

    wrapper._eval = with_jax_draws
    images = fixture[0][:n]
    got, want = wrapper.infer(images), jax_wrapper.infer(images)
    assert calls == [0]
    assert got[0] == want[0]
    for k in (1, 2, 3, 4, 5):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


def test_infer_batch_trims_to_items(wrapper, fixture):
    out = wrapper.infer_batch(fixture[0][:5])
    assert out.rec_num_digits.shape == (5,)
    assert out.rec_windows.shape == (5, 3, 784)
    assert out.reconstruction.shape == (5, 2500)
    assert np.isfinite(out.loss) and out.loss.shape == ()
    assert out.accuracy == np.float32(np.mean(out.rec_num_digits == 0))


def test_same_seed_same_answers(config, fixture):
    params = load_params(CNN_CKPT)
    a = ModelWrapper(config, params, seed=3, device="cpu")
    b = ModelWrapper(config.replace(st_impl="xla"), params, seed=3,
                     decoder_layout="scan", device="cpu")
    for n in (1, 8):
        ga, gb = a.infer(fixture[0][:n]), b.infer(fixture[0][:n])
        assert ga[0] == gb[0]
        np.testing.assert_allclose(np.stack(ga[2]), np.stack(gb[2]),
                                   rtol=0, atol=1e-5)


RAW_CKPT = os.path.join(REPO, "model", "air-model-80000.npz")
# the JAX package's bars for its shipped checkpoints
# (tests/test_shipped_model.py:20-40,65-89)
BARS = {CNN_CKPT: 0.9, RAW_CKPT: 0.8}


def test_serving_defaults_to_stepparallel_and_matches_scan():
    """The default wrapper of st_impl="xla" is step-parallel and answers
    bit for bit as a forced-scan wrapper with the same seed, over two
    calls of 5 frames (tests/test_serve.py:220-234 holds the JAX wrapper
    so), at the JAX package's SMALL config."""
    jcfg = JAX_SMALL
    cfg = CFG.replace(**{f: getattr(jcfg, f) for f in (
        "max_steps", "max_digits", "rnn_units", "canvas_size",
        "windows_size", "vae_latent_dimensions", "vae_recognition_units",
        "vae_generative_units", "scale_hidden_units", "shift_hidden_units",
        "z_pres_hidden_units", "cnn", "st_impl")})
    params = jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    w_sp = ModelWrapper(cfg, params, seed=3, device="cpu")
    w_scan = ModelWrapper(cfg, params, seed=3, decoder_layout="scan",
                          device="cpu")
    assert (w_sp.config.decoder_layout, w_scan.config.decoder_layout) == (
        "stepparallel", "scan")
    rng = np.random.default_rng(0)
    cs = cfg.canvas_size
    frames = []
    for _ in range(5):
        img = np.zeros((cs, cs), np.float32)
        x, y = rng.integers(2, cs - 8, 2)
        img[y:y + 6, x:x + 6] = 1.0
        frames.append(img)
    for _ in range(2):
        out_sp, out_scan = w_sp.infer(frames), w_scan.infer(frames)
        assert out_sp[0] == out_scan[0]
        for field_sp, field_scan in zip(out_sp[1:], out_scan[1:]):
            for a, b in zip(field_sp, field_scan):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("path", list(BARS), ids=os.path.basename)
def test_shipped_checkpoints_serve_stepparallel(path, fixture):
    """ModelWrapper(DEFAULT_TRAINING_CONFIG.replace(**checkpoint_arch(p)),
    load_params(p)), as the JAX package serves both shipped checkpoints:
    the step-parallel decoder, digit counts at the JAX package's bar, and
    the forced-scan wrapper's digit counts with its reconstructions to
    2e-5 (the JAX package's bar between its two layouts,
    tests/test_model.py:245-263; PyTorch's CPU GEMM rounds a row of the
    checkpoint's column-major head weights by the number of rows)."""
    canvases, truth = fixture
    config = CFG.replace(**checkpoint_arch(path))
    wrapper = ModelWrapper(config, load_params(path), seed=0, device="cpu")
    scan = ModelWrapper(config, load_params(path), seed=0,
                        decoder_layout="scan", device="cpu")
    assert wrapper.config.decoder_layout == "stepparallel"
    for n in (1, 8, 60):
        got, want = wrapper.infer(canvases[:n]), scan.infer(canvases[:n])
        assert got[0] == want[0]
        np.testing.assert_allclose(np.stack(got[2]), np.stack(want[2]),
                                   rtol=2e-5, atol=2e-5)
    acc = float(np.mean(np.asarray(got[0]) == truth))
    assert acc >= BARS[path], f"{os.path.basename(path)} accuracy {acc}"


@pytest.mark.parametrize("n", [1, 8, 60])
def test_stepparallel_infer_matches_jax(fixture, n):
    """The port's default wrapper given the JAX default wrapper's draws
    returns its answers: both serve the CNN checkpoint step-parallel."""
    jax_cfg = JAX_CFG.replace(cnn=True)
    jax_wrapper = JaxWrapper(jax_cfg, jax_load_params(CNN_CKPT), seed=4)
    wrapper = ModelWrapper(CFG.replace(cnn=True), load_params(CNN_CKPT),
                           seed=4, device="cpu")
    assert jax_wrapper.config.decoder_layout == \
        wrapper.config.decoder_layout == "stepparallel"
    forward = wrapper._eval

    def with_jax_draws(params, images, targets, step, generator=None):
        key = jax.random.fold_in(jax.random.PRNGKey(4), 1)
        return forward(params, images, targets, step,
                       noise=jax_noise(key, jax_cfg, len(images)))

    wrapper._eval = with_jax_draws
    images = fixture[0][:n]
    got, want = wrapper.infer(images), jax_wrapper.infer(images)
    assert got[0] == want[0]
    for k in (1, 2, 3, 4, 5):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["inline", "pallas"])
def test_kernel_paths_keep_their_layout(impl):
    """st_impl "inline" and "pallas" serve with their own (scan) layout and
    their kernels, as the JAX wrapper keeps a Pallas config's layout."""
    wrapper = ModelWrapper(CFG.replace(cnn=True, st_impl=impl),
                           load_params(CNN_CKPT), device="cpu")
    assert wrapper.config.decoder_layout == "scan"
    forced = ModelWrapper(CFG.replace(cnn=True), load_params(CNN_CKPT),
                          decoder_layout="scan", device="cpu")
    assert forced.config.decoder_layout == "scan"


def test_bfloat16_serving_counts_digits(fixture):
    """The CNN checkpoint served step-parallel at compute_dtype="bfloat16"
    keeps the bar, and counts as the float32 wrapper does on all but a few
    canvases (on this fixture, all)."""
    canvases, truth = fixture
    config = CFG.replace(cnn=True)
    got = ModelWrapper(config.replace(compute_dtype="bfloat16"),
                       load_params(CNN_CKPT), seed=0,
                       device="cpu").infer(canvases)
    f32 = ModelWrapper(config, load_params(CNN_CKPT), seed=0,
                       device="cpu").infer(canvases)
    assert float(np.mean(np.asarray(got[0]) == truth)) >= 0.9
    assert got[0] == f32[0]
    assert all(r.dtype == np.float32 for r in got[2])


def test_empty_request_is_refused(wrapper):
    with pytest.raises(ValueError, match="no images"):
        wrapper.infer(np.zeros((0, 2500), np.float32))


def test_default_device_is_cuda(config):
    """No silent CPU fallback: without a card the default device fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        ModelWrapper(config, load_params(CNN_CKPT))
