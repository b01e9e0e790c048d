"""The port's attention read and write-accumulate (air_tpu_torch.kernels.
st_inline) against the TPU kernels of air_tpu/kernels/st_inline.py, run in
interpret mode as tests/test_pallas_inline.py runs them. On CPU tensors the
port's wrappers compute their plain PyTorch versions; the CUDA kernels are
held against those on the card by the gpu-marked test, which is the one
test of this file that runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_st_inline.py

Tolerance 1e-5:
float32 sums of up to 50 products in another order, over hat weights whose
grid points round one ulp apart in the two kernels."""

import numpy as np
import pytest
import torch

from air_tpu_torch.kernels import st_inline

try:    # the machine with the card has no JAX; only the gpu test runs there
    import jax.numpy as jnp
    from air_tpu.kernels.st_inline import (
        inline_attention_read as jax_read,
        inline_write_accumulate as jax_write)
except ImportError:
    jnp = jax_read = jax_write = None

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(30, 12), (50, 28)]


def _inputs(b, cs, ws, seed):
    rng = np.random.default_rng(seed)
    return dict(
        images=rng.uniform(size=(b, cs, cs)).astype(np.float32),
        canvas=rng.uniform(size=(b, cs * cs)).astype(np.float32),
        windows=rng.uniform(size=(b, ws * ws)).astype(np.float32),
        s=rng.uniform(0.1, 1.0, b).astype(np.float32),
        x=rng.uniform(-1.0, 1.0, b).astype(np.float32),
        y=rng.uniform(-1.0, 1.0, b).astype(np.float32),
        coeff=rng.uniform(0.0, 1.0, b).astype(np.float32))


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", [1, 5, 7])
def test_read_matches_tpu_kernel(b, cs, ws):
    d = _inputs(b, cs, ws, seed=b)
    want = jax_read(jnp.asarray(d["images"]), jnp.asarray(d["s"]),
                    jnp.asarray(d["x"]), jnp.asarray(d["y"]), ws,
                    interpret=True)
    t = _torch(d)
    got = st_inline.inline_attention_read(t["images"], t["s"], t["x"],
                                          t["y"], ws)
    assert got.shape == (b, ws, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", [1, 5, 7])
def test_write_accumulate_matches_tpu_kernel(b, cs, ws):
    d = _inputs(b, cs, ws, seed=10 + b)
    want = jax_write(*(jnp.asarray(d[k]) for k in
                       ("canvas", "windows", "s", "x", "y", "coeff")),
                     cs, interpret=True)
    t = _torch(d)
    got = st_inline.inline_write_accumulate(
        t["canvas"], t["windows"], t["s"], t["x"], t["y"], t["coeff"], cs)
    assert got.shape == (b, cs * cs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_write_takes_square_windows_and_keeps_canvas():
    d = _torch(_inputs(3, 30, 12, seed=3))
    canvas = d["canvas"].clone()
    flat = st_inline.inline_write_accumulate(
        d["canvas"], d["windows"], d["s"], d["x"], d["y"], d["coeff"], 30)
    square = st_inline.inline_write_accumulate(
        d["canvas"], d["windows"].reshape(3, 12, 12), d["s"], d["x"], d["y"],
        d["coeff"], 30)
    torch.testing.assert_close(flat, square, rtol=0, atol=0)
    torch.testing.assert_close(d["canvas"], canvas, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    st_inline.reset_launches()
    d = _torch(_inputs(2, 30, 12, seed=4))
    st_inline.inline_attention_read(d["images"], d["s"], d["x"], d["y"], 12)
    st_inline.inline_write_accumulate(d["canvas"], d["windows"], d["s"],
                                      d["x"], d["y"], d["coeff"], 30)
    assert st_inline.LAUNCHES == {"inline_attention_read": 0,
                                  "inline_write_accumulate": 0}


@pytest.mark.parametrize("bad", ["float64", "shape", "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    d = _torch(_inputs(2, 30, 12, seed=5))
    if bad == "float64":
        d["s"] = d["s"].double()
        err = TypeError
    elif bad == "shape":
        d["s"] = d["s"][:1]
        err = ValueError
    else:
        d["s"] = d["s"].to("meta")
        err = ValueError
    with pytest.raises(err):
        st_inline.inline_attention_read(d["images"], d["s"], d["x"], d["y"],
                                        12)
    with pytest.raises(err):
        st_inline.inline_write_accumulate(d["canvas"], d["windows"], d["s"],
                                          d["x"], d["y"], d["coeff"], 30)


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """Build the CUDA kernels, launch each on the card and hold it against
    its plain version; every launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    for b in (1, 7, 64):
        for cs, ws in SHAPES:
            d = _torch(_inputs(b, cs, ws, seed=20 + b), "cuda")
            st_inline.reset_launches()
            got = st_inline.inline_attention_read(d["images"], d["s"],
                                                  d["x"], d["y"], ws)
            torch.cuda.synchronize()
            want = st_inline.attention_read_plain(d["images"], d["s"],
                                                  d["x"], d["y"], ws)
            torch.testing.assert_close(got, want, **TOL)
            got = st_inline.inline_write_accumulate(
                d["canvas"], d["windows"], d["s"], d["x"], d["y"],
                d["coeff"], cs)
            torch.cuda.synchronize()
            want = st_inline.write_accumulate_plain(
                d["canvas"].reshape(b, cs, cs),
                d["windows"].reshape(b, ws, ws), d["s"], d["x"], d["y"],
                d["coeff"], cs).reshape(b, cs * cs)
            torch.testing.assert_close(got, want, **TOL)
            assert st_inline.LAUNCHES == {"inline_attention_read": 1,
                                          "inline_write_accumulate": 1}
