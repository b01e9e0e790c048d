"""The port's TensorBoard event writer and metrics sinks against the JAX
package's: at a fixed wall time and host name both write the same bytes,
event by event, and MetricsWriter writes the same JSONL records (the time
field aside) and the same event files from numpy values and from the
port's tensors. Comparisons are exact."""

import json
import os

import numpy as np
import pytest
import torch

from air_tpu.train import metrics as jax_metrics
from air_tpu.utils import tb_writer as jax_tb
from air_tpu_torch.train import metrics
from air_tpu_torch.utils import tb_writer

WALL = 1_700_000_000.25


@pytest.fixture
def fixed_clock(monkeypatch):
    for module in (jax_tb, tb_writer, jax_metrics, metrics):
        monkeypatch.setattr(module.time, "time", lambda: WALL)
    for module in (jax_tb, tb_writer):
        monkeypatch.setattr(module.socket, "gethostname", lambda: "host")


def _histogram_values():
    return np.random.default_rng(0).normal(size=300)


EVENTS = {
    "scalar": lambda w: w.add_scalar("train/loss", 1.5, step=10),
    "scalars": lambda w: w.add_scalars({"test/a": 1.0, "test/b": -2.25},
                                       step=30),
    "histogram": lambda w: w.add_histogram("var/w", _histogram_values(),
                                           step=7, bins=13),
    "empty-histogram": lambda w: w.add_histogram("var/e", np.array([np.nan]),
                                                 step=1),
    "negative-step": lambda w: w.add_scalar("x", -3.0, step=-1),
}


@pytest.mark.parametrize("event", list(EVENTS))
def test_event_files_are_the_same_bytes(event, fixed_clock, tmp_path):
    paths = []
    for name, module in (("jax", jax_tb), ("port", tb_writer)):
        w = module.EventWriter(str(tmp_path / name))
        EVENTS[event](w)
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and len(got) > 0


@pytest.mark.parametrize("data", [b"", b"123456789", bytes(range(256))])
def test_crc32c_matches(data):
    assert tb_writer.crc32c(data) == jax_tb.crc32c(data)
    assert tb_writer.masked_crc32c(data) == jax_tb.masked_crc32c(data)


SCALARS = {"loss": np.float32(2.5), "accuracy": np.float32(0.75),
           "nested": {"a": np.float32(1.0), "b": np.float32(np.nan)},
           "vector": np.arange(3, dtype=np.float32),
           "count": np.int32(4)}


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "torch"])
def test_metrics_writer_matches_jax(tensors, fixed_clock, tmp_path):
    """The same records and event bytes; the port's writer takes its
    tensors (0-d and vectors, float32 and int32) as the JAX one takes
    numpy values."""
    given = SCALARS
    if tensors:
        def to_torch(v):
            return ({k: to_torch(x) for k, x in v.items()}
                    if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
        given = {k: to_torch(v) for k, v in SCALARS.items()}
    hist = {"w": np.linspace(-1, 1, 50, dtype=np.float32)}
    written = {}
    for name, module, scalars, arrays in (
            ("jax", jax_metrics, SCALARS, hist),
            ("port", metrics, given,
             {k: torch.from_numpy(v) for k, v in hist.items()} if tensors
             else hist)):
        w = module.MetricsWriter(str(tmp_path / name), tensorboard=True)
        w.write(5, scalars, prefix="train/")
        w.write_histograms(5, arrays, prefix="var/")
        w.close()
        with open(w.path) as f:
            lines = [json.loads(line) for line in f]
        with open(w._tb.path, "rb") as f:
            written[name] = (lines, f.read())
    (want_lines, want_tb), (got_lines, got_tb) = written["jax"], \
        written["port"]
    assert json.dumps(got_lines) == json.dumps(want_lines)
    assert got_tb == want_tb


def test_variable_summaries_match_jax():
    rng = np.random.default_rng(2)
    tree = {"lstm": {"kernel": rng.normal(size=(4, 8)).astype(np.float32),
                     "bias": rng.normal(size=8).astype(np.float32)},
            "heads": [{"w": rng.normal(size=(3, 2)).astype(np.float32)}]}
    port_tree = {"lstm": {k: torch.from_numpy(v)
                          for k, v in tree["lstm"].items()},
                 "heads": [{"w": torch.from_numpy(tree["heads"][0]["w"])}]}
    assert metrics.variable_summaries(port_tree) == \
        jax_metrics.variable_summaries(tree)
    got, want = metrics.named_leaves(port_tree), \
        jax_metrics.named_leaves(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
