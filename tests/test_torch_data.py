"""The port's data path against the JAX package's, on the same inputs: AIRREC
records written by either package and read by the other, TrainLoader
batches over two epochs (numpy and native permutations, through state /
restore and reseed), load_test_data, the procedural backgrounds, the
multi-MNIST generator's canvases and metadata, MNIST readers, and the
committed digit pool. Every comparison is exact (bit for bit): the port
keeps the JAX package's numpy code and the order of its draws."""

import gzip
import os
import struct
import sys

import numpy as np
import pytest
import torch

from air_tpu.data import backgrounds as jax_bg
from air_tpu.data import loader as jax_loader
from air_tpu.data import mnist as jax_mnist
from air_tpu.data import multi_mnist as jax_mm
from air_tpu.data import records as jax_records
from air_tpu.runtime import native as jax_native
from air_tpu_torch.data import backgrounds, loader, mnist, multi_mnist, records
from air_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from make_torch_digit_pool import make_pool  # noqa: E402


def native_builds() -> bool:
    try:
        native.build_native()
        jax_native.build_native()
        return True
    except Exception:
        return False


@pytest.fixture(scope="module")
def pool():
    """200 digits of the JAX package's renderer."""
    return jax_mnist.synthesize_mnist(n=200, seed=0)


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# --- records ------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_read(writer, tmp_path):
    rng = np.random.default_rng(0)
    n = 7
    images = rng.uniform(size=(n, 50 * 50)).astype(np.float32)
    digits = np.array([0, 1, 2, 1, 0, 2, 2], np.int32)
    indices = [list(rng.integers(0, 200, d)) for d in digits]
    positions = [list(rng.integers(0, 40, 2 * d)) for d in digits]
    boxes = [list(rng.integers(5, 20, 2 * d)) for d in digits]
    labels = [list(rng.integers(0, 10, d)) for d in digits]
    write = {"jax": jax_records, "port": records}[writer].write_records
    read_by = {"jax": records, "port": jax_records}[writer]
    path = write(str(tmp_path / "set"), images, digits, indices, positions,
                 boxes, labels, max_digits=2)
    got = read_by.read_records(path)
    want = {"jax": jax_records, "port": records}[writer].read_records(path)
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k])
    assert_same(got["images"], images)
    for shift in (False, True):
        for g, w in zip(read_by.read_test_data(path, shift),
                        jax_records.read_test_data(path, shift)):
            if isinstance(w, list):
                assert len(g) == len(w)
                for gi, wi in zip(g, w):
                    assert_same(gi, wi)
            else:
                assert_same(g, w)


@pytest.mark.parametrize("shift", [False, True])
def test_load_test_data(shift, tmp_path):
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(9, 100)).astype(np.float32)
    digits = np.array([1, 0, 2, 0, 1, 0, 2, 1, 1], np.int32)
    path = records.write_records(str(tmp_path / "test"), images, digits)
    got = loader.load_test_data(path, shift_zero_digits_images=shift)
    want = jax_loader.load_test_data(path, shift_zero_digits_images=shift)
    for g, w in zip(got, want):
        assert_same(g, w)


# --- loaders ------------------------------------------------------------------

def _arrays(n=21, width=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, width)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _take(it, k):
    return [next(it) for _ in range(k)]


def _as_numpy(batch):
    return tuple(b.numpy() if isinstance(b, torch.Tensor) else b
                 for b in batch)


@pytest.mark.parametrize("scenario", ["two_epochs", "restore", "reseed"])
@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_train_loader_matches_jax(backend, scenario):
    """Same arrays, seed and backend: the same batches bit for bit, the
    same state(), through a restore mid-epoch and through a reseed."""
    use_native = backend == "native"
    if use_native and not native_builds():
        pytest.skip("g++ does not build the native loader here")
    data = _arrays()
    kw = dict(batch_size=4, seed=5, native=use_native)
    port = loader.TrainLoader(data, epochs=2, prefetch=2,
                              device_put=loader.to_device("cpu"), **kw)
    ref = jax_loader.TrainLoader(data, epochs=2, prefetch=2, **kw)
    assert port.state() == ref.state()
    if scenario == "restore":
        mid = {"epoch": 0, "index": 8, "seed": 5,
               "perm_backend": ref.state()["perm_backend"]}
        port.restore(mid)
        ref.restore(mid)
    if scenario == "reseed":
        _take(iter(port), 3)
        _take(iter(ref), 3)
        port.reseed(11)
        ref.reseed(11)
    got = [_as_numpy(b) for b in port]
    want = list(ref)
    assert len(got) == len(want) == (2 * 5 - (2 if scenario == "restore"
                                              else 0))
    for (gi, gd), (wi, wd) in zip(got, want):
        assert_same(gi, wi)
        assert_same(gd, wd)
    assert port.state() == ref.state()


def test_native_permutations_match_jax():
    if not native_builds():
        pytest.skip("g++ does not build the native loader here")
    images, digits = _arrays(n=1000)
    port = native.NativeShuffleLoader(images, digits, 8)
    ref = jax_native.NativeShuffleLoader(images, digits, 8)
    for seed in (0, 1, 1009, 2 ** 40 + 3):
        port.seed = ref.seed = seed
        for epoch in (0, 1, 7):
            assert_same(port.perm(epoch), ref.perm(epoch))
    idx = port.perm(3)[:37]
    for g, w in zip(port.gather(idx), ref.gather(idx)):
        assert_same(g, w)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_device_pipeline_sees_the_host_order(backend):
    """The device-data pipeline gathers the host loader's batches in the
    host loader's order, and its state() restores the same position."""
    use_native = backend == "native"
    if use_native and not native_builds():
        pytest.skip("g++ does not build the native loader here")
    images, digits = _arrays()
    host = list(loader.TrainLoader((images, digits), 4, epochs=2, seed=2,
                                   prefetch=0, native=use_native))
    pipe = loader.DeviceDataPipeline(images, digits, 4, seed=2,
                                     device="cpu", native=use_native)
    got = []
    while len(got) < len(host):
        k = pipe.chunk(3)
        got += [pipe.gather_batch(i) for i in range(k)]
        pipe.advance(k)
    assert len(got) == len(host) == 10
    for (gi, gd), (wi, wd) in zip(got, host):
        assert_same(gi.numpy(), wi)
        assert_same(gd.numpy(), wd)
    state = pipe.state()
    assert state["device_pipeline"] and state["perm_backend"] == backend
    again = loader.DeviceDataPipeline(images, digits, 4, seed=9,
                                      device="cpu", native=use_native)
    again.restore(state)
    assert (again.epoch, again.index, again.seed) == (pipe.epoch, pipe.index,
                                                      2)
    for g, w in zip(again.gather_batch(), pipe.gather_batch()):
        assert torch.equal(g, w)


def test_loader_guards():
    images, digits = _arrays(n=3)
    with pytest.raises(ValueError, match="no full batch"):
        loader.TrainLoader((images, digits), 4)
    with pytest.raises(ValueError, match="no full batch"):
        loader.DeviceDataPipeline(images, digits, 4, device="cpu")


# --- backgrounds --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["noise", "gradient", "stripes", "blobs",
                                  "checker"])
@pytest.mark.parametrize("seed", [0, 7])
def test_backgrounds_match_jax(kind, seed):
    assert_same(backgrounds.generate_background(kind, 50, seed, 0.3),
                jax_bg.generate_background(kind, 50, seed, 0.3))


def test_background_bank_and_estimate_match_jax():
    for g, w in zip(backgrounds.background_bank(40, 3),
                    jax_bg.background_bank(40, 3)):
        assert_same(g, w)
    images, digits = _arrays(n=12, width=25)
    for d in (digits, None):
        assert_same(backgrounds.estimate_background(images, d),
                    jax_bg.estimate_background(images, d))


# --- the generator ------------------------------------------------------------

GENERATOR_CASES = {
    "default": {},
    "scaled-rotated-gap": dict(min_width_scale=0.8, max_width_scale=1.1,
                               min_height_scale=0.8, max_height_scale=1.1,
                               min_rotation_angle=-20.0,
                               max_rotation_angle=20.0, digit_gap=2),
    "bbox-margin-background": dict(use_bounding_box_overlap=True,
                                   canvas_margin=1, bg_kind="blobs",
                                   bg_max_intensity=0.3),
}


@pytest.mark.parametrize("case", list(GENERATOR_CASES))
def test_generate_dataset_matches_jax(case, pool, tmp_path):
    kw = dict(images_per_digit=12, test_set_size=8, seed=3,
              **GENERATOR_CASES[case])
    got = multi_mnist.generate_dataset(
        *pool, multi_mnist.MultiMNISTConfig(**kw), out_dir=str(tmp_path))
    want = jax_mm.generate_dataset(*pool, jax_mm.MultiMNISTConfig(**kw))
    assert got["used_digit_ids"] == want["used_digit_ids"]
    parts = [(got[s], want[s]) for s in ("test", "common")] + [
        (got["strata"][d], want["strata"][d]) for d in want["strata"]]
    for g, w in parts:
        assert set(g) == set(w)
        for field in w:
            assert len(g[field]) == len(w[field])
            for gi, wi in zip(g[field], w[field]):
                assert_same(gi, wi)
    # and the files the port wrote hold the same canvases
    on_disk = jax_records.read_records(str(tmp_path / "test.airrec"))
    assert_same(on_disk["images"],
                np.stack(want["test"]["images"]).reshape(8, -1))


def test_png_background_needs_pil(monkeypatch, tmp_path):
    """A PNG background no longer needs PIL: with PIL unimportable it is
    read by the port's own decoder, as the JAX package reads it with PIL
    (tests/test_torch_realdata.py holds the decoder to PIL's bits); the
    procedural kinds still work."""
    path = os.path.join(REPO, "images", "harder_ref_textures.png")
    want = jax_mm.prepare_background(50, bg_path=path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = multi_mnist.prepare_background(50, bg_path=path)
    np.testing.assert_array_equal(got, want)
    assert multi_mnist.prepare_background(50, bg_kind="noise").shape == (50,
                                                                         50)


# --- MNIST sources and the digit pool -----------------------------------------

def _write_idx(path, array):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("form", ["npz", "idx", "idx.gz"])
def test_load_mnist_matches_jax(form, tmp_path):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (6, 28, 28)).astype(np.uint8)
    y = rng.integers(0, 10, 6).astype(np.uint8)
    if form == "npz":
        np.savez(tmp_path / "mnist.npz", x_train=x, y_train=y)
    else:
        suffix = ".gz" if form.endswith(".gz") else ""
        _write_idx(str(tmp_path / f"train-images-idx3-ubyte{suffix}"), x)
        _write_idx(str(tmp_path / f"train-labels-idx1-ubyte{suffix}"), y)
    got = mnist.get_mnist(str(tmp_path))
    want = jax_mnist.get_mnist(str(tmp_path), allow_synthetic=False)
    assert got[2] == want[2] == "mnist"
    for g, w in zip(got[:2], want[:2]):
        assert_same(g, w)


def test_pool_encoding_matches_jax_renderer():
    """The pool script's encode/decode on 500 digits gives the JAX
    package's synthesize_mnist(500, 0) bit for bit."""
    arrays, images = make_pool(500, 0)
    want, labels = jax_mnist.synthesize_mnist(500, 0)
    assert_same(images, want)
    assert_same(mnist.decode_pool(arrays["k"], arrays["u"]), want)
    assert_same(arrays["labels"], labels)
    assert str(arrays["sha256"]) == mnist.images_sha256(want)
    assert arrays["k"].dtype == np.uint8 and arrays["u"].dtype == np.float32


def test_committed_pool_decodes_to_its_sha256(tmp_path):
    images, labels = mnist.load_digit_pool()
    assert images.shape == (60000, 784) and images.dtype == np.float32
    assert labels.shape == (60000,) and labels.dtype == np.int32
    with np.load(mnist.POOL) as z:
        assert mnist.images_sha256(images) == str(z["sha256"])
    got = mnist.get_mnist(str(tmp_path / "absent"))
    assert got[2] == "synthetic"
    assert_same(got[0], images)


@pytest.mark.slow
def test_committed_pool_is_the_jax_renderers_60000():
    """A full regeneration (about a minute): the committed pool is the JAX
    package's synthesize_mnist(60000, 0)."""
    images, labels = jax_mnist.synthesize_mnist(60000, 0)
    with np.load(mnist.POOL) as z:
        assert mnist.images_sha256(images) == str(z["sha256"])
        assert_same(z["labels"], labels)
