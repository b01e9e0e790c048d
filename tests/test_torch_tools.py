"""The port's tools (air_tpu_torch.tools: headless_demo, embeddings,
demo_tk) and its demo and embeddings entry points, each held against the
JAX package's function on the same input: the geometry helpers and the
matching must be equal, the projector TSV, metadata and config files
byte-equal, and the sprite's pixels equal (the port writes the PNG itself;
both are decoded through PIL here). Where a function serves a model, both
packages' functions are given the port's wrapper, so they see the same
answers. The Tk widgets run on the fake tkinter of
tests/test_demo_tk_widgets.py."""

import io
import json
import os

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py pins it)
import numpy as np
import pytest
from PIL import Image

import embeddings as jax_cli
from air_tpu.tools import demo_tk as jax_tk
from air_tpu.tools import embeddings as jax_emb
from air_tpu.tools import headless_demo as jax_headless
from air_tpu_torch import demo as port_demo
from air_tpu_torch import embeddings as port_cli
from air_tpu_torch.data.records import write_records
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG as CFG
from air_tpu_torch.serve.model_wrapper import ModelWrapper
from air_tpu_torch.tools import demo_tk, embeddings, headless_demo
from air_tpu_torch.train.checkpoint import load_params
from air_tpu_torch.train.visualize import write_png
from tests.test_demo_tk_widgets import (_Event, _FakeWrapper, _Master,
                                        fake_tk)  # noqa: F401  (fixture)
from tests.test_torch_model import CNN_CKPT, FIXTURE


def wrapper(seed=0):
    return ModelWrapper(CFG.replace(cnn=True), load_params(CNN_CKPT),
                        seed=seed, device="cpu")


@pytest.fixture(scope="module")
def canvases():
    with np.load(FIXTURE) as z:
        return z["canvases"]


def record_file(path, n=12, seed=0, cs=50):
    """A test record file of 0-2 squares, with their true geometry."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, cs, cs), np.float32)
    digits = rng.integers(0, 3, n)
    indices, positions, boxes, labels = [], [], [], []
    for i in range(n):
        idx, pos, box, lab = [], [], [], []
        for j in range(digits[i]):
            x, y = rng.integers(2, cs - 16, 2)
            images[i, y:y + 14, x:x + 10] = 1.0
            idx.append(i * 10 + j)
            pos.extend([int(x), int(y)])
            box.extend([10, 14])
            lab.append(int(rng.integers(0, 10)))
        indices.append(idx)
        positions.append(pos)
        boxes.append(box)
        labels.append(lab)
    return write_records(str(path), images, digits, indices, positions,
                         boxes, labels, max_digits=2)


# --- headless demo -----------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(4, 1), (20, 0)])
def test_scribble_frames_match_jax(n, seed):
    got = list(headless_demo.scribble_frames(50, n, seed))
    want = list(jax_headless.scribble_frames(50, n, seed))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_headless_stream_matches_jax(canvases, batch_size):
    """The same frames through the same-seeded wrappers: the same JSON
    lines but for the measured latency."""
    frames = list(canvases[:5].reshape(5, 50, 50))
    lines = []
    for stream in (headless_demo.stream, jax_headless.stream):
        buf = io.StringIO()
        stats = stream(wrapper(), frames, batch_size=batch_size, out=buf,
                       include_windows=True)
        assert stats["frames"] == 5 and stats["frames_per_sec"] > 0
        recs = [json.loads(line) for line in buf.getvalue().splitlines()]
        for r in recs:
            assert r.pop("latency_ms") > 0
        lines.append(recs)
    assert lines[0] == lines[1]
    assert [r["frame"] for r in lines[0]] == list(range(5))


def test_demo_entry_point_streams_json_lines(capsys):
    """python -m air_tpu_torch.demo --headless N on the CPU: N JSON lines in
    headless_demo.stream's format on stdout."""
    stats = port_demo.main(["--headless", "6", "--model-path", CNN_CKPT,
                            "--batch-size", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    recs = [json.loads(line) for line in out]
    assert stats["frames"] == len(recs) == 6
    for i, r in enumerate(recs):
        assert set(r) == {"frame", "digits", "boxes", "nll", "latency_ms"}
        assert r["frame"] == i and len(r["boxes"]) == r["digits"]


def test_demo_refuses_an_empty_checkpoint_folder(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoints"):
        port_demo.main(["--headless", "1", "--model-path", str(tmp_path),
                        "--device", "cpu"])


# --- embeddings --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ([1], [[0]], [[0, 0]], [[50, 50]], [[5]]),
    ([1], [[0]], [[0, 0]], [[2, 2]], [[5]]),
    ([2, 0, 1], [[3, 4], [], [9]], [[1, 2, 30, 7], [], [11, 12]],
     [[10, 14, 9, 13], [], [12, 15]], [[1, 7], [], [3]])], ids=str)
def test_collect_data_info_matches_jax(case):
    assert embeddings.collect_data_info(*case, canvas_size=50) == \
        jax_emb.collect_data_info(*case, canvas_size=50)


def _rec_info(shifts):
    return [{"num_digits": len(s), "digits": [
        {"shift": np.array(x), "window": np.full((4, 4), k, np.float32),
         "latent": np.arange(3) + 10 * k} for k, x in enumerate(s)]}
        for s in shifts]


@pytest.mark.parametrize("shifts,max_distance", [
    ([[[0.52, 0.51], [-0.48, -0.52]]], 0.1),
    ([[[0.52, 0.51], [0.53, 0.5]]], 0.1),
    ([[[0.52, 0.51], [-0.48, -0.52]]], 0.01),
    ([[[0.3, 0.3], [-0.5, -0.5], [0.5, 0.5]]], 0.5)], ids=str)
def test_match_data_with_rec_matches_jax(shifts, max_distance):
    data_info = [{"num_digits": 2, "digits": [
        {"id": 7, "label": 3, "st_center": [0.5, 0.5]},
        {"id": 9, "label": 1, "st_center": [-0.5, -0.5]}]}]
    got = embeddings.match_data_with_rec(data_info, _rec_info(shifts),
                                         max_distance)
    want = jax_emb.match_data_with_rec(data_info, _rec_info(shifts),
                                       max_distance)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_collect_reconstruction_info_matches_jax(canvases):
    out = wrapper().infer(canvases[:6])
    digits, positions, _, windows, latents, _ = out
    got = embeddings.collect_reconstruction_info(digits, positions, windows,
                                                 latents, 28)
    want = jax_emb.collect_reconstruction_info(digits, positions, windows,
                                               latents, 28)
    assert [i["num_digits"] for i in got] == [i["num_digits"] for i in want]
    for g, w in zip(got, want):
        for dg, dw in zip(g["digits"], w["digits"]):
            assert dg.keys() == dw.keys()
            for k in dg:
                np.testing.assert_array_equal(dg[k], dw[k])


def _files(folder):
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder))}


def _sprite_pixels(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_projector_dataset_matches_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    latents = rng.normal(size=(n, 6))
    images = rng.uniform(size=(n, 28, 28))
    labels = list(rng.integers(0, 10, n))
    got = embeddings.write_projector_dataset(str(tmp_path / "port"), latents,
                                             images, labels, 28)
    want = jax_emb.write_projector_dataset(str(tmp_path / "jax"), latents,
                                           images, labels, 28)
    assert got.keys() == want.keys()
    for k in ("tensors", "metadata", "config"):
        assert open(got[k], "rb").read() == open(want[k], "rb").read(), k
    mode, pixels = _sprite_pixels(got["sprites"])
    want_mode, want_pixels = _sprite_pixels(want["sprites"])
    assert mode == want_mode == "L"
    np.testing.assert_array_equal(pixels, want_pixels)


def test_write_png_decodes(tmp_path):
    """The port's PNG writer, grey and RGB, read back through PIL."""
    rng = np.random.default_rng(0)
    grey = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    rgb = rng.integers(0, 256, (3, 4, 3), dtype=np.uint8)
    for name, pix, mode in (("g.png", grey, "L"), ("c.png", rgb, "RGB")):
        write_png(str(tmp_path / name), pix)
        got_mode, got = _sprite_pixels(tmp_path / name)
        assert got_mode == mode
        np.testing.assert_array_equal(got, pix)


def test_embeddings_run_matches_jax(tmp_path):
    """run(): the test records read, inferred by same-seeded wrappers,
    matched and written: the same statistics and the same files."""
    path = record_file(tmp_path / "test", n=16, seed=2)
    stats = embeddings.run(wrapper(), path, str(tmp_path / "port"),
                           verbose=False)
    want = jax_emb.run(wrapper(), path, str(tmp_path / "jax"),
                       verbose=False)
    assert stats == want and stats["matched"] > 0
    got_files, want_files = (_files(tmp_path / "port"),
                             _files(tmp_path / "jax"))
    assert got_files.keys() == want_files.keys()
    for name in got_files:
        if name.endswith(".png"):
            np.testing.assert_array_equal(
                _sprite_pixels(tmp_path / "port" / name)[1],
                _sprite_pixels(tmp_path / "jax" / name)[1])
        else:
            assert got_files[name] == want_files[name], name


def test_embeddings_entry_point(tmp_path, monkeypatch, capsys):
    """python -m air_tpu_torch.embeddings on the CPU writes the projector
    files into a fresh folder and prints the match statistics."""
    monkeypatch.chdir(tmp_path)
    path = record_file(tmp_path / "test", n=16, seed=2)
    stats = port_cli.main(["--model-path", CNN_CKPT, "--test-data", path,
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"Matched inference boxes: {stats['matched']}" in out
    assert sorted(os.listdir(tmp_path / "embeddings")) == [
        "air_mnist_tensors.tsv", "mnist_metadata.tsv", "mnist_sprites.png",
        "projector_config.pbtxt"]
    assert _sprite_pixels(tmp_path / "embeddings" / "mnist_sprites.png")[0] \
        == "L"


@pytest.mark.parametrize("contents,refused", [
    (["air-model-55000.npz"], True),
    (["vae_tensors.tsv", "mnist_metadata.tsv", "mnist_sprites.png",
      "projector_config.pbtxt"], False),
    (["mnist_metadata.tsv", "notes.txt"], True),
    (None, False)], ids=str)
def test_prepare_results_folder_matches_jax(tmp_path, contents, refused):
    """The refuse-to-wipe guard: a folder holding anything the tool did not
    write survives untouched; a previous output is wiped; a missing folder
    is made. Both packages' guards act alike."""
    for pkg, prepare in (("port", port_cli.prepare_results_folder),
                         ("jax", jax_cli.prepare_results_folder)):
        folder = tmp_path / pkg
        if contents is not None:
            folder.mkdir()
            for name in contents:
                (folder / name).write_text("old")
        if refused:
            with pytest.raises(SystemExit) as e:
                prepare(str(folder))
            assert "refusing" in str(e.value)
            assert sorted(os.listdir(folder)) == sorted(contents)
        else:
            prepare(str(folder))
            assert folder.is_dir() and not list(folder.iterdir())


# --- the Tk demo's geometry --------------------------------------------------

@pytest.mark.parametrize("stroke", [
    ((100, 60, 100, 60, 8.0, 8.0), 1, 1.0),
    ((200, 200, 200, 200, 8.0, 8.0), 3, 1.0),
    ((0, 0, 399, 399, 8.0, 8.0), 2, 1.0),
    ((10, 390, 390, 15, 8.0, 8.0), 5, 1.0),
    ((0, 0, 0, 0, 8.0, 8.0), 3, 0.0),
    ((-100, -100, -100, -100, 8.0, 8.0), 3, 0.0),
    ((30, 40, 250, 120, 6.5, 9.25), 4, 1.0)], ids=str)
def test_paint_stroke_matches_jax(stroke):
    coords, width, value = stroke
    start = np.random.default_rng(0).integers(0, 2, (50, 50)).astype(
        np.float32)
    got, want = start.copy(), start.copy()
    demo_tk.paint_stroke(got, *coords, width, value)
    jax_tk.paint_stroke(want, *coords, width, value)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [
    (2.0, 0.0, 0.0, 400, 400), (0.5, 0.0, 0.0, 400, 400),
    (0.5, 1.0, 0.0, 400, 400), (0.4, 0.2, -0.3, 50, 50),
    (0.37, -0.81, 0.66, 123, 77)], ids=str)
def test_bbox_canvas_coords_matches_jax(box):
    assert demo_tk.bbox_canvas_coords(*box) == \
        jax_tk.bbox_canvas_coords(*box)


@pytest.mark.parametrize("shape,cw,ch", [
    ((2, 2), 8, 8), ((3, 3), 10, 10), ((50, 50), 400, 400),
    ((28, 28), 120, 120), ((5, 7), 33, 21)], ids=str)
def test_upscale_for_display_matches_jax(shape, cw, ch):
    image = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    got = demo_tk.upscale_for_display(image, cw, ch)
    want = jax_tk.upscale_for_display(image, cw, ch)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# --- the Tk widgets, on the fake tkinter -------------------------------------

def _canvas_state(pc):
    return (pc.image.copy(), pc.photo.data, pc.photo.format,
            {i: dict(v) for i, v in pc.canvas.items.items()},
            sorted(pc.canvas.handlers), pc.bbox_positions,
            pc.bbox_visibility, pc.erasing, pc.line_width)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        elif isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                assert {kk: vv for kk, vv in x[k].items() if kk != "image"} \
                    == {kk: vv for kk, vv in y[k].items() if kk != "image"}
        else:
            assert x == y


def test_pixel_canvas_matches_jax(fake_tk):  # noqa: F811
    """Clicks, drags, bbox items and the PPM frame of both PixelCanvases."""
    states = []
    for module in (demo_tk, jax_tk):
        pc = module.PixelCanvas(None, 50, 50, drawable=True, width=400,
                                height=400)
        pc.canvas.handlers["<Button-1>"](_Event(100, 60))
        pc.canvas.handlers["<B1-Motion>"](_Event(180, 90))
        pc.set_line_width(5)
        pc.canvas.handlers["<B1-Motion>"](_Event(300, 310))
        pc.set_bbox_positions([(0.5, 0.0, 0.0), (0.25, -0.5, 0.5)])
        pc.set_erasing_mode(True)
        pc.canvas.handlers["<B1-Motion>"](_Event(120, 70))
        states.append(_canvas_state(pc))
        pc.set_bbox_visibility(False)
        states.append(_canvas_state(pc))
        pc.canvas.handlers["<Button-3>"](_Event(0, 0))
        states.append(_canvas_state(pc))
    for got, want in zip(states[:3], states[3:]):
        _same(got, want)


def test_demo_window_matches_jax(fake_tk):  # noqa: F811
    """Both DemoWindows through their traces and two inference ticks."""
    runs = []
    for module in (demo_tk, jax_tk):
        master, fake = _Master(), _FakeWrapper()
        win = module.DemoWindow(master, fake, canvas_size=50,
                                window_size=28, refresh_period=50)
        win.rate_var.set("200")
        win.width_var.set("4")
        master.after_calls[0][1]()
        win.bbox_var.set(0)
        master.after_calls[-1][1]()
        runs.append((win, master, fake))
    (got, g_master, g_fake), (want, w_master, w_fake) = runs
    assert g_fake.calls == w_fake.calls == 2
    assert [ms for ms, _ in g_master.after_calls] == \
        [ms for ms, _ in w_master.after_calls]
    assert got.status.kw == want.status.kw
    for a, b in zip([got.cnv_orig, got.cnv_rec, *got.cnv_win],
                    [want.cnv_orig, want.cnv_rec, *want.cnv_win]):
        _same(_canvas_state(a), _canvas_state(b))
