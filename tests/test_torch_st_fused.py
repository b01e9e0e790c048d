"""The port's streamed-weight write-accumulate (air_tpu_torch.kernels.
st_fused) against the TPU kernels of air_tpu/kernels/st_fused.py, run in
interpret mode as tests/test_pallas.py runs them: values, the gradients of
all six inputs (through ``jax.vjp``), and the core backward (d_Wy, d_win,
d_Wx, d_coeff) against ``jax.vjp`` of ``_wmac_core`` on the same weight
matrices. Batches 1, 7, 12 and 64, for which the TPU kernels take blocks of
1, 7, 6 and 8 images (``_pick_block``). On CPU tensors the port's autograd
Function computes the plain PyTorch versions; the CUDA kernels are held
against them on the card by the gpu-marked test, which is the one test of
this file that runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_st_fused.py

JAX is given the port's linspace grid for the weight matrices, as
tests/test_torch_st_pallas.py explains; inputs are in the ranges of
tests/test_pallas.py (s in [0.2, 0.9], x and y in [-0.7, 0.7]).

Tolerances. Values 1e-5. The matrix cotangents (canvas, windows, and in
the core d_Wy, d_win, d_Wx) and the core's d_coeff, where both packages
share the weights: rtol 1e-4 / atol 1e-5, the tolerances of
tests/test_pallas.py:80-102. The cotangents of s, x, y and coeff through
the whole op: 1e-4 times max(1, the largest magnitude in the batch); each
is a sum of thousands of products chained through the weights' slopes and
1/s^2, whose rounding scales with its terms, not its result (measured at
B = 64: d_y -1.12039 against JAX's -1.12055 in a batch of such sums), as
tests/test_torch_st_inline.py holds them."""

import numpy as np
import pytest
import torch

from air_tpu_torch.kernels import st_fused, st_pallas
from air_tpu_torch.ops import transformer as ttr

try:    # the machine with the card has no JAX; only the gpu test runs there
    import jax
    import jax.numpy as jnp
    from air_tpu.kernels.st_fused import _wmac_core
    from air_tpu.kernels.st_fused import \
        fused_write_accumulate as jax_fused
except ImportError:
    jax = jnp = _wmac_core = jax_fused = None

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(20, 8), (50, 28)]
BATCHES = [1, 7, 12, 64]
NAMES = ("canvas", "windows", "s", "x", "y", "coeff")
# the forward's launch geometry: the tests' and the model's shapes, cs 100,
# and an odd shape whose ranges are not 16-byte multiples (4-byte copies)
GEOMETRY_SHAPES = [(20, 8), (50, 28), (100, 28), (21, 7)]
GEOMETRY_BATCHES = [1, 7, 64, 1024]
CARD_SHAPES = SHAPES + [(100, 28), (21, 7)]
CARD_BATCHES = [1, 7, 64, 256]


@pytest.fixture
def same_grid(monkeypatch):
    """JAX's weight matrices on the port's linspace grid."""
    monkeypatch.setattr(
        jnp, "linspace",
        lambda start, stop, n: jnp.asarray(ttr._linspace(n, "cpu").numpy()))


def _inputs(b, cs, ws, seed):
    rng = np.random.default_rng(seed)
    return dict(
        canvas=rng.uniform(size=(b, cs * cs)).astype(np.float32),
        windows=rng.uniform(size=(b, ws, ws)).astype(np.float32),
        s=rng.uniform(0.2, 0.9, b).astype(np.float32),
        x=rng.uniform(-0.7, 0.7, b).astype(np.float32),
        y=rng.uniform(-0.7, 0.7, b).astype(np.float32),
        coeff=rng.uniform(0.0, 1.0, b).astype(np.float32))


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


def _weights(d, cs, ws):
    """The write's (Wy, Wx) [B, cs, ws], as the wrapper builds them."""
    inv_s = 1.0 / d["s"]
    return (ttr._axis_weight_matrix(inv_s, -d["y"] * inv_s, cs, ws),
            ttr._axis_weight_matrix(inv_s, -d["x"] * inv_s, cs, ws))


def _close_per_batch(got, want, tol=1e-4):
    """|got - want| <= tol * max(1, max |want|) over the whole array."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", BATCHES)
def test_matches_tpu_kernels(b, cs, ws, same_grid):
    """Values and the gradients of canvas, windows, s, x, y and coeff."""
    d = _inputs(b, cs, ws, seed=b)
    g = np.random.default_rng(100 + b).normal(size=(b, cs * cs)).astype(
        np.float32)
    out, vjp = jax.vjp(lambda *a: jax_fused(*a, cs, interpret=True),
                       *(jnp.asarray(d[k]) for k in NAMES))
    want = vjp(jnp.asarray(g))
    t = {k: v.requires_grad_(True) for k, v in _torch(d).items()}
    got_out = st_fused.fused_write_accumulate(*(t[k] for k in NAMES), cs)
    assert got_out.shape == (b, cs * cs)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **TOL)
    got = torch.autograd.grad(got_out, [t[k] for k in NAMES],
                              torch.from_numpy(g))
    np.testing.assert_array_equal(got[0].numpy(), g)
    for name, gg, ww in zip(NAMES[1:], got[1:], want[1:]):
        if name == "windows":
            np.testing.assert_allclose(gg.numpy(), np.asarray(ww),
                                       err_msg=name, **GRAD_TOL)
        else:
            _close_per_batch(gg.numpy(), ww)


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", BATCHES)
def test_core_backward_matches_tpu_kernel(b, cs, ws):
    """(d_win, d_Wy, d_Wx, d_coeff) of the backward against jax.vjp of
    _wmac_core, on the same weight matrices."""
    d = _torch(_inputs(b, cs, ws, seed=20 + b))
    wy, wx = _weights(d, cs, ws)
    canvas = d["canvas"].reshape(b, cs, cs)
    g = np.random.default_rng(120 + b).normal(size=(b, cs, cs)).astype(
        np.float32)
    args = (canvas, d["windows"], wy, wx, d["coeff"])
    _, vjp = jax.vjp(lambda *a: _wmac_core(*a, True),
                     *(jnp.asarray(a.numpy()) for a in args))
    want = vjp(jnp.asarray(g))
    got = st_fused.wmac_bwd(d["windows"], wy, wx, d["coeff"],
                            torch.from_numpy(g))
    for name, gg, ww in zip(("win", "Wy", "Wx", "coeff"), got, want[1:]):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("b", [1, 7])
def test_plain_backward_matches_autograd_of_plain_forward(b):
    """The explicit backward formulas against torch autograd through the
    plain forward, for every input of the kernel."""
    cs, ws = 50, 28
    d = _torch(_inputs(b, cs, ws, seed=30 + b))
    wy, wx = _weights(d, cs, ws)
    g = torch.from_numpy(np.random.default_rng(b).normal(
        size=(b, cs, cs)).astype(np.float32))
    got = st_fused.wmac_bwd_plain(d["windows"], wy, wx, d["coeff"], g)
    leaves = [t.clone().requires_grad_(True) for t in
              (d["canvas"].reshape(b, cs, cs), d["windows"], wy, wx,
               d["coeff"])]
    want = torch.autograd.grad(st_fused.wmac_fwd_plain(*leaves), leaves, g)
    torch.testing.assert_close(want[0], g, rtol=0, atol=0)
    for name, gg, ww in zip(("win", "Wy", "Wx"), got[:3], want[1:4]):
        torch.testing.assert_close(gg, ww, **TOL, msg=name)
    _close_per_batch(got[3].numpy(), want[4].numpy())


@pytest.mark.parametrize("cs,ws", SHAPES)
def test_same_values_as_the_transformer_ops(cs, ws):
    """On the CPU the op is the plain write of air_tpu_torch.ops.transformer
    accumulated into the canvas, bit for bit."""
    b = 5
    d = _torch(_inputs(b, cs, ws, seed=40))
    want = d["canvas"] + d["coeff"][:, None] * ttr.attention_write(
        d["windows"], d["s"], d["x"], d["y"], cs).reshape(b, cs * cs)
    torch.testing.assert_close(
        st_fused.fused_write_accumulate(*(d[k] for k in NAMES), cs), want,
        rtol=0, atol=0)


def test_takes_square_windows_and_keeps_canvas():
    d = _torch(_inputs(3, 20, 8, seed=3))
    canvas = d["canvas"].clone()
    square = st_fused.fused_write_accumulate(*(d[k] for k in NAMES), 20)
    flat = st_fused.fused_write_accumulate(
        d["canvas"], d["windows"].reshape(3, 64), d["s"], d["x"], d["y"],
        d["coeff"], 20)
    torch.testing.assert_close(flat, square, rtol=0, atol=0)
    torch.testing.assert_close(d["canvas"], canvas, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    st_fused.reset_launches()
    d = {k: v.requires_grad_(True)
         for k, v in _torch(_inputs(2, 20, 8, seed=4)).items()}
    st_fused.fused_write_accumulate(*(d[k] for k in NAMES), 20).sum(
        ).backward()
    assert st_fused.LAUNCHES == {"fused_write_accumulate": 0,
                                 "fused_write_accumulate_bwd": 0}


@pytest.mark.parametrize("bad", ["float64", "shape", "device", "windows"])
def test_wrapper_refuses_what_the_kernels_do_not_take(bad):
    d = _torch(_inputs(2, 20, 8, seed=5))
    err = ValueError
    if bad == "float64":
        d["coeff"] = d["coeff"].double()
        err = TypeError
    elif bad == "shape":
        d["s"] = d["s"][:1]
    elif bad == "device":
        d["s"] = d["s"].to("meta")
    else:
        d["windows"] = d["windows"][:, :7]
    with pytest.raises(err):
        st_fused.fused_write_accumulate(*(d[k] for k in NAMES), 20)


@pytest.mark.parametrize("cs,ws", GEOMETRY_SHAPES)
@pytest.mark.parametrize("b", GEOMETRY_BATCHES)
def test_forward_launch_geometry(b, cs, ws):
    """The forward kernel's geometry: row groups cover every canvas row
    once, each block's thread tiles cover its outputs once, a block (with its
    canvas rows) fits the card's shared memory, a batch of 64 gives every SM
    a block and one canvas more than one block; the bulk path at every shape
    but the odd one."""
    from tests.test_torch_st_pallas import check_geometry
    geo = st_fused.geometry(b, cs, ws)
    check_geometry(geo, b, cs, cs, ws, ws, canvas=True)
    assert geo.bulk == ((cs, ws) != (21, 7))
    assert geo == st_pallas.geometry(b, cs, cs, ws, ws, canvas=True)


def test_forward_refuses_a_block_that_does_not_fit():
    """Off the CPU the forward computes its geometry before it builds or
    launches anything: a 2000-wide canvas of 2-wide windows needs more than
    MAX_THREADS threads per block."""
    b, cs, ws, dev = 1, 2000, 2, "meta"
    w = torch.empty((b, cs, ws), device=dev)
    with pytest.raises(ValueError, match="threads"):
        st_fused.wmac_fwd(torch.empty((b, cs, cs), device=dev),
                          torch.empty((b, ws, ws), device=dev), w, w,
                          torch.empty((b,), device=dev))


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """Build the CUDA kernels, launch each on the card and hold it against
    its plain version, at the tests' and the model's shapes, cs 100 and the
    odd shape (21, 7) that takes the forward's 4-byte copy path; every launch
    is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    for b in CARD_BATCHES:
        for cs, ws in CARD_SHAPES:
            d = _torch(_inputs(b, cs, ws, seed=50 + b), "cuda")
            wy, wx = _weights(d, cs, ws)
            canvas = d["canvas"].reshape(b, cs, cs)
            g = torch.randn((b, cs, cs), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(b))
            st_fused.reset_launches()
            got = st_fused.wmac_fwd(canvas, d["windows"], wy, wx, d["coeff"])
            torch.cuda.synchronize()
            want = st_fused.wmac_fwd_plain(canvas, d["windows"], wy, wx,
                                           d["coeff"])
            torch.testing.assert_close(got, want, **TOL)
            got = st_fused.wmac_bwd(d["windows"], wy, wx, d["coeff"], g)
            torch.cuda.synchronize()
            want = st_fused.wmac_bwd_plain(d["windows"], wy, wx, d["coeff"],
                                           g)
            for gg, ww in zip(got[:3], want[:3]):
                torch.testing.assert_close(gg, ww, **TOL)
            err = (got[3] - want[3]).abs() / want[3].abs().clamp(min=1.0)
            assert float(err.max()) <= 1e-4
            assert st_fused.LAUNCHES == {"fused_write_accumulate": 1,
                                         "fused_write_accumulate_bwd": 1}
