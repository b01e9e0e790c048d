"""The port's real-handwriting data path on the CPU, against the JAX
package: the committed UCI digits (air_tpu_torch/assets/uci_digits_8x8.npz)
against scikit-learn's, their upsampling (data.mnist.load_sklearn_digits),
the PIL-free PNG reader (data/png.py) against PIL's ``convert("L")``, the
backgrounds read through it, the generator CLI (python -m
air_tpu_torch.generate_multi_mnist) against scripts/generate_multi_mnist.py
and the eval CLI (python -m air_tpu_torch.eval_checkpoint) against
scripts/eval_checkpoint.py.

Tolerances: bit for bit everywhere but the eval CLI, whose accuracy is held
exactly and its other numbers to 1e-4 (they are rounded to 3 places; the
forward itself agrees to 1e-4, tests/test_torch_model.py).
"""

import glob
import json
import os
import runpy
import struct
import sys
import zlib

import jax
import numpy as np
import pytest
from PIL import Image

from air_tpu.data import mnist as jax_mnist
from air_tpu.data import multi_mnist as jax_multi_mnist
from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu_torch import eval_checkpoint, generate_multi_mnist
from air_tpu_torch.data import mnist, multi_mnist, png
from air_tpu_torch.data.records import write_records
from tests.test_torch_model import jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = sorted(glob.glob(os.path.join(REPO, "images", "*.png")))
CKPT = os.path.join(REPO, "model", "air-model-cnn-47500.npz")
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")


def bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


# --- the UCI digits ---------------------------------------------------------

def test_asset_is_sklearn_digits():
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    glyphs, labels = mnist.load_uci_glyphs()
    np.testing.assert_array_equal(bits(glyphs),
                                  bits(d.images.astype(np.float32) / 16.0))
    np.testing.assert_array_equal(labels, d.target)
    assert labels.dtype == np.int32 and glyphs.shape == (1797, 8, 8)


@pytest.mark.parametrize("interp,size", [("bilinear", 20), ("bicubic", 20),
                                         ("bilinear", 16), ("bicubic", 24)])
def test_load_sklearn_digits_matches_jax(interp, size):
    want, want_labels = jax_mnist.load_sklearn_digits(size, interp)
    got, labels = mnist.load_sklearn_digits(size, interp)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(labels, want_labels)


def test_upsample_weights_match_jax():
    for interp in ("bilinear", "bicubic"):
        np.testing.assert_array_equal(
            bits(mnist._upsample_weights(20, 8, interp)),
            bits(jax_mnist._upsample_weights(20, 8, interp)))
    t = np.linspace(-2.5, 2.5, 101, dtype=np.float32)
    np.testing.assert_array_equal(bits(mnist._cubic_kernel(t)),
                                  bits(jax_mnist._cubic_kernel(t)))
    with pytest.raises(ValueError, match="interp"):
        mnist._upsample_weights(20, 8, "nearest")


def test_a_changed_asset_is_refused(tmp_path, monkeypatch):
    glyphs, labels = mnist.load_uci_glyphs()
    with np.load(mnist.UCI_DIGITS) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["glyphs"] = arrays["glyphs"].copy()
    arrays["glyphs"][0, 0, 0] ^= 1
    path = str(tmp_path / "digits.npz")
    np.savez(path, **arrays)
    monkeypatch.setattr(mnist, "UCI_DIGITS", path)
    with pytest.raises(ValueError, match="sha256"):
        mnist.load_uci_glyphs()


# --- the PNG reader -------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(row: bytes, prior: bytes, bpp: int, kind: int) -> bytes:
    """One row under filter ``kind``, as the PNG spec writes it."""
    out = bytearray([kind])
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        out.append((x - (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind])
                   & 0xFF)
    return bytes(out)


def write_png(path, samples, color, filters, palette=None, depth=8,
              interlace=0, trns=None):
    """A PNG written by hand: ``samples`` [H, W, C] uint8, row y filtered
    by ``filters[y % len(filters)]``."""
    h, w, c = samples.shape
    raw, prior = b"", bytes(w * c)
    for y in range(h):
        row = samples[y].reshape(-1).tobytes()
        raw += _filtered(row, prior, c, filters[y % len(filters)])
        prior = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_is_pil_convert_l(tmp_path, color, kind):
    """Each colour type under each filter type (every row one filter, and
    the five mixed), at odd widths, against PIL's convert("L")."""
    rng = np.random.default_rng(10 * color + kind)
    for width in (1, 7, 13):
        for filters in ([kind], [kind, 4, 0, 3, 1, 2]):
            palette = trns = None
            if color == 3:
                palette = rng.integers(0, 256, (17, 3), dtype=np.uint8)
                samples = rng.integers(0, 17, (6, width, 1), dtype=np.uint8)
                trns = b"\x00\x80"
            else:
                samples = rng.integers(0, 256, (
                    6, width, png.CHANNELS[color]), dtype=np.uint8)
            path = str(tmp_path / f"c{color}_f{kind}_w{width}.png")
            write_png(path, samples, color, filters, palette, trns=trns)
            with Image.open(path) as im:
                want = np.asarray(im.convert("L"))
            got = png.read_png_grey(path)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", IMAGES, ids=os.path.basename)
def test_png_reader_reads_the_committed_images(path):
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(png.read_png_grey(path), want)


@pytest.mark.parametrize("case,match", [
    ("16-bit", "bit depth 16"), ("4-bit", "bit depth 4"),
    ("interlaced", "Adam7"), ("not a PNG", "not a PNG"),
    ("bad CRC", "CRC"), ("bad filter", "filter type 5")])
def test_png_reader_refuses(tmp_path, case, match):
    path = str(tmp_path / "x.png")
    samples = np.zeros((3, 4, 1), np.uint8)
    if case == "16-bit":
        write_png(path, samples, 0, [0], depth=16)
    elif case == "4-bit":
        write_png(path, samples, 0, [0], depth=4)
    elif case == "interlaced":
        write_png(path, samples, 0, [0], interlace=1)
    elif case == "not a PNG":
        Image.fromarray(samples[..., 0]).save(str(tmp_path / "x.bmp"))
        path = str(tmp_path / "x.bmp")
    elif case == "bad CRC":
        write_png(path, samples, 0, [0])
        data = bytearray(open(path, "rb").read())
        data[-20] ^= 0xFF                          # inside IDAT
        open(path, "wb").write(bytes(data))
    else:
        write_png(path, samples, 0, [0])
        data = open(path, "rb").read()
        raw = bytes([5]) + bytes(4) + bytes([0] + [0] * 4) * 2
        i = data.index(b"IDAT") - 4
        data = data[:i] + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(
            b"IEND", b"")
        open(path, "wb").write(data)
    with pytest.raises(ValueError, match=match):
        png.read_png_grey(path)


@pytest.mark.parametrize("max_intensity", [1.0, 0.4])
def test_read_image_matches_jax(max_intensity):
    for path in IMAGES:
        np.testing.assert_array_equal(
            bits(multi_mnist.read_image(path, max_intensity)),
            bits(jax_multi_mnist.read_image(path, max_intensity)))


# --- the CLIs -----------------------------------------------------------

def run_script(monkeypatch, script: str, argv: list) -> None:
    monkeypatch.setattr(sys, "argv", [script, *argv])
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")


@pytest.mark.parametrize("flags", [
    ["--source", "sklearn", "--digit-slice", ":1400", "--upsample",
     "bicubic", "--bg-path", os.path.join(REPO, "images",
                                          "harder_ref_textures.png")],
    ["--source", "sklearn", "--digit-slice", "1400:", "--images-per-digit",
     "12", "--max-digits", "3", "--max-in-common", "3"],
    ["--source", "sklearn", "--bg-kind", "stripes", "--bg-max-intensity",
     "0.5", "--min-width-scale", "0.8", "--max-rotation-angle", "10"]],
    ids=["slice-bicubic-png", "held-out-3-digits", "procedural-bg"])
def test_generator_cli_writes_the_jax_records(tmp_path, monkeypatch, flags):
    common = ["--images-per-digit", "15", "--test-set-size", "6", *flags]
    run_script(monkeypatch, "generate_multi_mnist.py",
               [*common, "--out-folder", str(tmp_path / "jax")])
    generate_multi_mnist.main([*common, "--out-folder",
                               str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "common.airrec" in names and "test.airrec" in names
    for name in names:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name


def test_eval_cli_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The shipped CNN checkpoint on 20 fixture canvases in chunks of 8,
    the port fed the JAX script's draws (each chunk's start folded into
    PRNGKey(0))."""
    with np.load(FIXTURE) as z:
        write_records(str(tmp_path / "test.airrec"), z["canvases"][:20],
                      z["digits"][:20])
    argv = ["--model-path", CKPT, "--test-data", str(tmp_path / "test.airrec"),
            "--batch-size", "8"]
    capsys.readouterr()
    run_script(monkeypatch, "eval_checkpoint.py", argv)
    want = json.loads(capsys.readouterr().out)
    jcfg = JaxConfig(cnn=True)
    got = eval_checkpoint.main(
        [*argv, "--device", "cpu"],
        draws=lambda lo: {"noise": jax_noise(
            jax.random.fold_in(jax.random.PRNGKey(0), lo), jcfg, 8)})
    assert set(got) == set(want)
    assert (got["checkpoint"], got["n"], got["accuracy"]) == (
        want["checkpoint"], want["n"], want["accuracy"])
    for key in set(want) - {"checkpoint"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=0,
                                   err_msg=key)


def test_eval_cli_takes_a_directory(tmp_path):
    """A directory gives its latest checkpoint, through the inline
    kernels' plain versions on the CPU; an empty one exits."""
    models = tmp_path / "models"
    models.mkdir()
    with np.load(FIXTURE) as z:
        write_records(str(tmp_path / "test.airrec"), z["canvases"][:6],
                      z["digits"][:6])
    argv = ["--test-data", str(tmp_path / "test.airrec"), "--device", "cpu",
            "--batch-size", "4"]
    with pytest.raises(SystemExit, match="no checkpoints"):
        eval_checkpoint.main(["--model-path", str(models), *argv])
    for step in (5, 40):
        os.symlink(CKPT, models / f"air-model-{step}.npz")
    got = eval_checkpoint.main(["--model-path", str(models), *argv])
    assert got["checkpoint"].endswith("air-model-40.npz")
    assert got["n"] == 6 and got["accuracy"] >= 0.8
