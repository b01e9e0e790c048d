"""The port's attention read and write-accumulate (air_tpu_torch.kernels.
st_inline), forward and backward, against the TPU kernels of
air_tpu/kernels/st_inline.py, run in interpret mode as
tests/test_pallas_inline.py runs them (the backward through ``jax.vjp``).
On CPU tensors the port's autograd Functions compute the plain PyTorch
versions; the CUDA kernels are held against those on the card by the
gpu-marked test, which is the one test of this file that runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_st_inline.py

Tolerances. Values and the matrix cotangents (d_images, d_windows): 1e-5,
float32 sums of up to 50 products in another order, over hat weights whose
grid points round one ulp apart in the two kernels. Scalar cotangents (of
s, x, y, coeff): 1e-4 times max(1, the largest magnitude in the batch). Each
is a sum of 1,400 (28 x 50) products times (in - 1.001) / 2 (24.5 for the
read, 13.5 for the write), and then chained through 1/s; the rounding of such
a sum scales with its terms, not with its result, so an element that cancels
to near zero carries the batch's absolute rounding (measured: 6.8e-4 on a
value of 5.3 in a batch whose largest is 170)."""

import numpy as np
import pytest
import torch

from air_tpu_torch.kernels import st_inline
from air_tpu_torch.ops.transformer import (_axis_weight_matrix,
                                           attention_read, attention_write)

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


def _close_per_batch(got, want, tol=1e-4):
    """|got - want| <= tol * max(1, max |want|) over the whole array."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _cotangents(b, cs, ws, seed):
    """Signed cotangents of magnitude <= 1, the scale of the forward inputs:
    the TPU kernel forms each hat position with a fused multiply-add, one ulp
    of p (up to 3.8e-6) from the port's, so the two agree to about
    ulp(p) * |g| on the matrix cotangents."""
    rng = np.random.default_rng(100 + seed)
    return (rng.uniform(-1.0, 1.0, (b, ws, ws)).astype(np.float32),
            rng.uniform(-1.0, 1.0, (b, cs * cs)).astype(np.float32))


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


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", [1, 5, 7])
def test_read_grads_match_tpu_kernel(b, cs, ws):
    """d_images, d_s, d_x, d_y through the read Function (plain backward on
    CPU tensors) against jax.vjp of the TPU kernels."""
    import jax
    d = _inputs(b, cs, ws, seed=b)
    g, _ = _cotangents(b, cs, ws, b)
    names = ("images", "s", "x", "y")
    _, vjp = jax.vjp(lambda *a: jax_read(*a, ws, interpret=True),
                     *(jnp.asarray(d[k]) for k in names))
    want = vjp(jnp.asarray(g))
    t = {k: v.requires_grad_(True) for k, v in _torch(d).items()}
    out = st_inline.inline_attention_read(*(t[k] for k in names), ws)
    got = torch.autograd.grad(out, [t[k] for k in names],
                              torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for gg, ww in zip(got[1:], want[1:]):
        _close_per_batch(gg.numpy(), ww)


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", [1, 5, 7])
def test_write_grads_match_tpu_kernel(b, cs, ws):
    """d_canvas (= g), d_windows, d_s, d_x, d_y, d_coeff through the write
    Function against jax.vjp of the TPU kernels."""
    import jax
    d = _inputs(b, cs, ws, seed=10 + b)
    _, g = _cotangents(b, cs, ws, 10 + b)
    names = ("canvas", "windows", "s", "x", "y", "coeff")
    _, vjp = jax.vjp(lambda *a: jax_write(*a, cs, interpret=True),
                     *(jnp.asarray(d[k]) for k in names))
    want = vjp(jnp.asarray(g))
    t = {k: v.requires_grad_(True) for k, v in _torch(d).items()}
    out = st_inline.inline_write_accumulate(*(t[k] for k in names), cs)
    got = torch.autograd.grad(out, [t[k] for k in names],
                              torch.from_numpy(g))
    np.testing.assert_array_equal(got[0].numpy(), g)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    for gg, ww in zip(got[2:], want[2:]):
        _close_per_batch(gg.numpy(), ww)


def _scalar_inputs(d):
    """Per-axis (a, c) of the read and of the write, as the wrappers form
    them from (s, x, y)."""
    s, x, y = d["s"], d["x"], d["y"]
    inv_s = 1.0 / s
    return (s, y, s, x), (inv_s, -y * inv_s, inv_s, -x * inv_s)


@pytest.mark.parametrize("b", [1, 5, 7])
def test_plain_read_bwd_matches_autograd_of_plain_forward(b):
    """The explicit backward formula against torch autograd through the
    plain forward, for every input of the kernel (the images and the four
    per-axis scalars)."""
    cs, ws = 50, 28
    d = _torch(_inputs(b, cs, ws, seed=30 + b))
    g = torch.from_numpy(_cotangents(b, cs, ws, 30 + b)[0])
    scalars, _ = _scalar_inputs(d)
    got = st_inline.attention_read_bwd_plain(d["images"], g, *scalars)
    leaves = [d["images"], *scalars]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    images, ay, cy, ax, cx = leaves
    out = torch.bmm(torch.bmm(_axis_weight_matrix(ay, cy, ws, cs), images),
                    _axis_weight_matrix(ax, cx, ws, cs).transpose(1, 2))
    want = torch.autograd.grad(out, leaves, g)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for gg, ww in zip(got[1:], want[1:]):
        _close_per_batch(gg.numpy(), ww.numpy())


@pytest.mark.parametrize("b", [1, 5, 7])
def test_plain_write_bwd_matches_autograd_of_plain_forward(b):
    cs, ws = 50, 28
    d = _torch(_inputs(b, cs, ws, seed=40 + b))
    g = torch.from_numpy(_cotangents(b, cs, ws, 40 + b)[1]).reshape(b, cs,
                                                                    cs)
    _, scalars = _scalar_inputs(d)
    windows = d["windows"].reshape(b, ws, ws)
    got = st_inline.write_accumulate_bwd_plain(windows, g, *scalars,
                                               d["coeff"])
    leaves = [t.clone().requires_grad_(True)
              for t in (windows, *scalars, d["coeff"])]
    win, ay, cy, ax, cx, coeff = leaves
    out = coeff[:, None, None] * torch.bmm(
        torch.bmm(_axis_weight_matrix(ay, cy, cs, ws), win),
        _axis_weight_matrix(ax, cx, cs, ws).transpose(1, 2))
    want = torch.autograd.grad(out, leaves, g)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for gg, ww in zip(got[1:], want[1:]):
        _close_per_batch(gg.numpy(), ww.numpy())


@pytest.mark.parametrize("cs,ws", SHAPES)
def test_plain_forwards_match_the_transformer_ops(cs, ws):
    """The kernels' plain forwards in (a, c) form, at the scalars the
    wrappers form from (s, x, y), are the model's read and write of
    air_tpu_torch.ops.transformer, bit for bit."""
    b = 5
    d = _torch(_inputs(b, cs, ws, seed=30))
    read_s, write_s = _scalar_inputs(d)
    torch.testing.assert_close(
        st_inline.attention_read_fwd_plain(d["images"], *read_s, ws),
        attention_read(d["images"], d["s"], d["x"], d["y"], ws),
        rtol=0, atol=0)
    canvas, windows = d["canvas"].reshape(b, cs, cs), d["windows"].reshape(
        b, ws, ws)
    torch.testing.assert_close(
        st_inline.write_accumulate_fwd_plain(canvas, windows, *write_s,
                                             d["coeff"]),
        canvas + d["coeff"][:, None, None] * attention_write(
            windows, d["s"], d["x"], d["y"], cs),
        rtol=0, atol=0)


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
    d = {k: v.requires_grad_(True)
         for k, v in _torch(_inputs(2, 30, 12, seed=4)).items()}
    read = st_inline.inline_attention_read(d["images"], d["s"], d["x"],
                                           d["y"], 12)
    write = st_inline.inline_write_accumulate(
        d["canvas"], d["windows"], d["s"], d["x"], d["y"], d["coeff"], 30)
    (read.sum() + write.sum()).backward()
    assert st_inline.LAUNCHES == {"inline_attention_read": 0,
                                  "inline_write_accumulate": 0,
                                  "inline_attention_read_bwd": 0,
                                  "inline_write_accumulate_bwd": 0}


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
            g_read, g_write = (torch.from_numpy(g).cuda() for g in
                               _cotangents(b, cs, ws, 20 + b))
            g_write = g_write.reshape(b, cs, cs)
            read_s, write_s = _scalar_inputs(d)
            windows = d["windows"].reshape(b, ws, ws)
            st_inline.reset_launches()
            got = st_inline.attention_read_bwd(d["images"], g_read, *read_s)
            torch.cuda.synchronize()
            want = st_inline.attention_read_bwd_plain(d["images"], g_read,
                                                      *read_s)
            torch.testing.assert_close(got[0], want[0], **TOL)
            for gg, ww in zip(got[1:], want[1:]):
                torch.testing.assert_close(
                    gg, ww, rtol=1e-4, atol=1e-4)
            got = st_inline.write_accumulate_bwd(windows, g_write, *write_s,
                                                 d["coeff"])
            torch.cuda.synchronize()
            want = st_inline.write_accumulate_bwd_plain(
                windows, g_write, *write_s, d["coeff"])
            torch.testing.assert_close(got[0], want[0], **TOL)
            for gg, ww in zip(got[1:], want[1:]):
                torch.testing.assert_close(gg, ww, rtol=1e-4, atol=1e-4)
            got = st_inline.inline_attention_read(d["images"], d["s"],
                                                  d["x"], d["y"], ws)
            torch.cuda.synchronize()
            want = st_inline.attention_read_fwd_plain(d["images"], *read_s,
                                                      ws)
            torch.testing.assert_close(got, want, **TOL)
            got = st_inline.inline_write_accumulate(
                d["canvas"], d["windows"], d["s"], d["x"], d["y"],
                d["coeff"], cs)
            torch.cuda.synchronize()
            want = st_inline.write_accumulate_fwd_plain(
                d["canvas"].reshape(b, cs, cs), windows, *write_s,
                d["coeff"]).reshape(b, cs * cs)
            torch.testing.assert_close(got, want, **TOL)
            assert st_inline.LAUNCHES == {"inline_attention_read": 1,
                                          "inline_write_accumulate": 1,
                                          "inline_attention_read_bwd": 1,
                                          "inline_write_accumulate_bwd": 1}
