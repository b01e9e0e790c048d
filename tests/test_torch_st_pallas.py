"""The port's streamed-weight attention read and write (air_tpu_torch.
kernels.st_pallas) against the TPU kernel of air_tpu/kernels/st_pallas.py,
run in interpret mode as tests/test_pallas.py runs it, values and the
gradients of every input (through ``jax.vjp``). On CPU tensors the port's
autograd Function computes the plain PyTorch version; the CUDA kernel is
held against it on the card by the gpu-marked test, which is the one test
of this file that runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_st_pallas.py

Both packages build the dense weight matrices outside the kernel from the
grid linspace(-1, 1, n). XLA rounds some points of its grid one ulp from
the port's (tests/test_torch_ops.py), which the write's 1/s magnifies to
~1e-5 in the weights (1.7e-5 in the write's values with s down to 0.1). So
JAX is given the port's grid, as tests/test_torch_ops.py gives it, and the
comparison holds the algebra after the grid. Inputs in the ranges of
tests/test_pallas.py: s in [0.2, 0.9], x and y in [-0.7, 0.7]. (A hat
position that lands exactly on an integer takes another one-sided slope in
each package, ROADMAP.md Queue 3; in float32 that happens, e.g. p = 25.0 at
s = 0.6106743, y = -0.010041848 for the write at cs 50, and moves d_s and
d_y by a tap's worth. The tests' draws hit no such point.)

Tolerances. Values 1e-5. The cotangents of the images or windows: rtol 1e-4
/ atol 1e-5, the tolerances of tests/test_pallas.py:105-119. The cotangents
of s, x and y: 1e-4 times max(1, the largest magnitude in the batch). Each
is a sum of some thousand products chained through the weights' slopes (and
1/s^2 in the write), so its rounding scales with its terms, not with its
result, and an element that cancels carries the batch's absolute rounding
(measured: d_y 0.78257 against JAX's 0.78248 in a batch whose largest is
582), as tests/test_torch_st_inline.py holds the same cotangents."""

import math

import numpy as np
import pytest
import torch

from air_tpu_torch.kernels import build, st_pallas
from air_tpu_torch.ops import transformer as ttr

try:    # the machine with the card has no JAX; only the gpu test runs there
    import jax
    import jax.numpy as jnp
    from air_tpu.kernels.st_pallas import (
        pallas_attention_read as jax_read,
        pallas_attention_write as jax_write)
except ImportError:
    jax = jnp = jax_read = jax_write = None

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SCALARS = ("s", "x", "y")
SHAPES = [(20, 8), (50, 28)]
BATCHES = [1, 3, 7]
# the launch geometry: the tests' and the model's shapes, cs 100, and an odd
# shape whose ranges are not 16-byte multiples (the 4-byte copy path)
GEOMETRY_SHAPES = [(20, 8), (50, 28), (100, 28), (21, 7)]
GEOMETRY_BATCHES = [1, 7, 64, 1024]
# the card-only test: every shape above, both directions
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
        images=rng.uniform(size=(b, cs, cs)).astype(np.float32),
        windows=rng.uniform(size=(b, ws, ws)).astype(np.float32),
        s=rng.uniform(0.2, 0.9, b).astype(np.float32),
        x=rng.uniform(-0.7, 0.7, b).astype(np.float32),
        y=rng.uniform(-0.7, 0.7, b).astype(np.float32))


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


def _close_per_batch(got, want, tol=1e-4):
    """|got - want| <= tol * max(1, max |want|) over the whole array."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _assert_grads(names, got, want):
    for name, gg, ww in zip(names, got, want):
        if name in SCALARS:
            _close_per_batch(gg.numpy(), ww)
        else:
            np.testing.assert_allclose(gg.numpy(), np.asarray(ww),
                                       err_msg=name, **GRAD_TOL)


def _vjp_case(d, names, jax_fn, port_fn, size, g):
    """(JAX's output and cotangents, the port's) for the inputs ``names``
    and output cotangent g."""
    out, vjp = jax.vjp(lambda *a: jax_fn(*a, size, interpret=True),
                       *(jnp.asarray(d[k]) for k in names))
    want = vjp(jnp.asarray(g))
    t = {k: v.requires_grad_(True) for k, v in _torch(d).items()}
    got_out = port_fn(*(t[k] for k in names), size)
    got = torch.autograd.grad(got_out, [t[k] for k in names],
                              torch.from_numpy(g))
    return (np.asarray(out), want), (got_out.detach().numpy(), got)


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", BATCHES)
def test_read_matches_tpu_kernel(b, cs, ws, same_grid):
    d = _inputs(b, cs, ws, seed=b)
    g = np.random.default_rng(100 + b).normal(size=(b, ws, ws)).astype(
        np.float32)
    (out, want), (got_out, got) = _vjp_case(
        d, ("images", "s", "x", "y"), jax_read,
        st_pallas.pallas_attention_read, ws, g)
    assert got_out.shape == (b, ws, ws)
    np.testing.assert_allclose(got_out, out, **TOL)
    _assert_grads(("images", "s", "x", "y"), got, want)


@pytest.mark.parametrize("cs,ws", SHAPES)
@pytest.mark.parametrize("b", BATCHES)
def test_write_matches_tpu_kernel(b, cs, ws, same_grid):
    d = _inputs(b, cs, ws, seed=10 + b)
    g = np.random.default_rng(110 + b).normal(size=(b, cs, cs)).astype(
        np.float32)
    (out, want), (got_out, got) = _vjp_case(
        d, ("windows", "s", "x", "y"), jax_write,
        st_pallas.pallas_attention_write, cs, g)
    assert got_out.shape == (b, cs, cs)
    np.testing.assert_allclose(got_out, out, **TOL)
    _assert_grads(("windows", "s", "x", "y"), got, want)


@pytest.mark.parametrize("b", [1, 7])
def test_function_backward_matches_autograd_of_plain(b):
    """The Function's backward products against autograd through the plain
    version, with respect to the images and both weight matrices."""
    cs, ws = 50, 28
    d = _torch(_inputs(b, cs, ws, seed=20 + b))
    wy = ttr._axis_weight_matrix(d["s"], d["y"], ws, cs)
    wx = ttr._axis_weight_matrix(d["s"], d["x"], ws, cs)
    g = torch.from_numpy(np.random.default_rng(b).normal(
        size=(b, ws, ws)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (d["images"], wy, wx)]
    got = torch.autograd.grad(
        st_pallas._FusedDots.apply(*leaves, "pallas_attention_read"),
        leaves, g)
    leaves = [t.clone().requires_grad_(True) for t in (d["images"], wy, wx)]
    want = torch.autograd.grad(
        st_pallas.fused_dots_plain(leaves[1], leaves[0], leaves[2]),
        leaves, g)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, **TOL)


@pytest.mark.parametrize("cs,ws", SHAPES)
def test_same_values_as_the_transformer_ops(cs, ws):
    """On the CPU the read and the write are the plain transformer ops of
    air_tpu_torch.ops.transformer, bit for bit."""
    d = _torch(_inputs(5, cs, ws, seed=30))
    torch.testing.assert_close(
        st_pallas.pallas_attention_read(d["images"], d["s"], d["x"],
                                        d["y"], ws),
        ttr.attention_read(d["images"], d["s"], d["x"], d["y"], ws),
        rtol=0, atol=0)
    torch.testing.assert_close(
        st_pallas.pallas_attention_write(d["windows"], d["s"], d["x"],
                                         d["y"], cs),
        ttr.attention_write(d["windows"], d["s"], d["x"], d["y"], cs),
        rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    st_pallas.reset_launches()
    d = {k: v.requires_grad_(True)
         for k, v in _torch(_inputs(2, 20, 8, seed=4)).items()}
    read = st_pallas.pallas_attention_read(d["images"], d["s"], d["x"],
                                           d["y"], 8)
    write = st_pallas.pallas_attention_write(d["windows"], d["s"], d["x"],
                                             d["y"], 20)
    (read.sum() + write.sum()).backward()
    assert st_pallas.LAUNCHES == {"pallas_attention_read": 0,
                                  "pallas_attention_write": 0}


@pytest.mark.parametrize("bad", ["float64", "shape", "device", "flat"])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    d = _torch(_inputs(2, 20, 8, seed=5))
    err = ValueError
    if bad == "float64":
        d["s"] = d["s"].double()
        err = TypeError
    elif bad == "shape":
        d["s"] = d["s"][:1]
    elif bad == "device":
        d["s"] = d["s"].to("meta")
    else:
        d["images"] = d["images"].reshape(2, -1)
        d["windows"] = d["windows"].reshape(2, -1)
    with pytest.raises(err):
        st_pallas.pallas_attention_read(d["images"], d["s"], d["x"], d["y"],
                                        8)
    with pytest.raises(err):
        st_pallas.pallas_attention_write(d["windows"], d["s"], d["x"],
                                         d["y"], 20)


def _row_ranges(geo, oh):
    """The output rows of each group, in order."""
    return [range(g * geo.rows, min(oh, (g + 1) * geo.rows))
            for g in range(geo.groups)]


def _tile_outputs(geo, oh, width):
    """The (row, column) outputs of each thread's register tile in one block
    of ``rg`` rows, as st_resample.cuh's Tile maps threads: rows p and
    p + half, columns q + c * ceil(width / TILE_COLS)."""
    qn = -(-width // st_pallas.TILE_COLS)
    half = geo.rows // 2
    for rows in _row_ranges(geo, oh):
        rg, seen = len(rows), []
        for t in range(geo.threads):
            p, q = divmod(t, qn)
            if p >= half:
                continue
            seen += [(i, q + c * qn) for i in (p, p + half) if i < rg
                     for c in range(st_pallas.TILE_COLS)
                     if q + c * qn < width]
        yield rg, seen


def check_geometry(geo, b, oh, ow, ih, iw, canvas):
    """What a launch geometry promises, for out [B, oh, ow] = Wy [B, oh, ih]
    @ X [B, ih, iw] @ Wx [B, ow, iw]^T."""
    ranges = _row_ranges(geo, oh)
    assert [i for r in ranges for i in r] == list(range(oh))
    assert all(len(r) > 0 for r in ranges) and geo.rows % 2 == 0
    half = geo.rows // 2
    # each block's tiles cover its rows of tmp [rg, iw] and of out
    # [rg, ow] once each
    for width in (iw, ow):
        for rg, seen in _tile_outputs(geo, oh, width):
            assert sorted(seen) == [(i, l) for i in range(rg)
                                    for l in range(width)]
    assert geo.threads % 32 == 0 and geo.threads <= st_pallas.MAX_THREADS
    # a warp's rows of Wy (stride ih) fall in distinct banks
    assert half <= 32 // math.gcd(ih, 32) or half == 1
    assert geo.smem_bytes == 4 * st_pallas._smem_floats(geo.rows, ow, ih, iw,
                                                        canvas)
    assert geo.smem_bytes <= build.MAX_SMEM_BYTES
    sizes = [ih * iw, geo.rows * ih, oh * ih, ow * iw]
    sizes += [geo.rows * ow, oh * ow] if canvas else []
    assert geo.bulk == all(n % 4 == 0 for n in sizes)
    blocks = b * geo.groups
    assert blocks > 1 and (b < 64 or blocks >= st_pallas.SMS)


@pytest.mark.parametrize("direction", ["read", "write"])
@pytest.mark.parametrize("cs,ws", GEOMETRY_SHAPES)
@pytest.mark.parametrize("b", GEOMETRY_BATCHES)
def test_launch_geometry(b, cs, ws, direction):
    """Row groups cover every output row once, each block's thread tiles
    cover its outputs once, a block fits the card's shared memory, a batch
    of 64 gives every SM a block and one image more than one block."""
    oh, ih = (ws, cs) if direction == "read" else (cs, ws)
    geo = st_pallas.geometry(b, oh, oh, ih, ih)
    check_geometry(geo, b, oh, oh, ih, ih, canvas=False)
    assert geo.bulk == ((cs, ws) != (21, 7))


@pytest.mark.parametrize("what", ["shared memory", "threads"])
def test_wrapper_refuses_a_block_that_does_not_fit(what):
    """Off the CPU the wrapper computes the geometry before it builds or
    launches anything, and refuses what one block cannot hold: a 300 x 300
    canvas (360 KB of shared memory), or a 2000-wide output of a 2-wide
    window (more than MAX_THREADS threads)."""
    (oh, ih), dev = ((8, 300) if what == "shared memory" else (2000, 2)), "meta"
    wy = torch.empty((1, oh, ih), device=dev)
    images = torch.empty((1, ih, ih), device=dev)
    with pytest.raises(ValueError, match=what):
        st_pallas.fused_dots(wy, images, wy, "pallas_attention_read")
    with pytest.raises(ValueError, match=what):
        st_pallas.geometry(1, oh, oh, ih, ih)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """Build the CUDA kernel, launch it on the card in both directions and
    hold it against its plain version, at the tests' and the model's shapes,
    cs 100 and the odd shape (21, 7) that takes the 4-byte copy path; every
    launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    for b in CARD_BATCHES:
        for cs, ws in CARD_SHAPES:
            d = _torch(_inputs(b, cs, ws, seed=40 + b), "cuda")
            inv_s = 1.0 / d["s"]
            cases = (
                ("pallas_attention_read", d["images"],
                 ttr._axis_weight_matrix(d["s"], d["y"], ws, cs),
                 ttr._axis_weight_matrix(d["s"], d["x"], ws, cs)),
                ("pallas_attention_write", d["windows"],
                 ttr._axis_weight_matrix(inv_s, -d["y"] * inv_s, cs, ws),
                 ttr._axis_weight_matrix(inv_s, -d["x"] * inv_s, cs, ws)))
            st_pallas.reset_launches()
            for name, images, wy, wx in cases:
                got = st_pallas.fused_dots(wy, images, wx, name)
                torch.cuda.synchronize()
                want = st_pallas.fused_dots_plain(wy, images, wx)
                torch.testing.assert_close(got, want, **TOL,
                                           msg=f"{name} B={b} cs={cs}")
            got = st_pallas.pallas_attention_read(d["images"], d["s"],
                                                  d["x"], d["y"], ws)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got, ttr.attention_read(d["images"], d["s"], d["x"], d["y"],
                                        ws), **TOL)
            got = st_pallas.pallas_attention_write(d["windows"], d["s"],
                                                   d["x"], d["y"], cs)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got, ttr.attention_write(d["windows"], d["s"], d["x"],
                                         d["y"], cs), **TOL)
            assert st_pallas.LAUNCHES == {"pallas_attention_read": 2,
                                          "pallas_attention_write": 2}
