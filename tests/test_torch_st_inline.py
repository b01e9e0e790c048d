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

from air_tpu_torch.kernels import build, cluster, st_inline
from air_tpu_torch.ops.transformer import (_axis_weight_matrix, _linspace,
                                           _pixel_coords, attention_read,
                                           attention_write)

try:    # the machine with the card has no JAX; only the gpu test runs there
    import jax.numpy as jnp
    from air_tpu.kernels.st_inline import (
        inline_attention_read as jax_read,
        inline_write_accumulate as jax_write)
except ImportError:
    jnp = jax_read = jax_write = None

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(30, 12), (50, 28)]
# each batch at each shape, and the scaled configuration's canvas 100
TWIN_CASES = [(b, cs, ws) for b in (1, 5, 7) for cs, ws in SHAPES] + [
    (3, 100, 28)]
# the read backward's launch geometry: the tests' and the model's shapes,
# cs 100, and an odd shape whose ranges are not 16-byte multiples
GEOMETRY_SHAPES = [(20, 8), (50, 28), (100, 28), (21, 7)]
GEOMETRY_BATCHES = [1, 7, 64, 1024]
CARD_SHAPES = SHAPES + [(100, 28), (21, 7)]
CARD_BATCHES = [1, 7, 64, 256]


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


@pytest.mark.parametrize("b,cs,ws", TWIN_CASES)
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


@pytest.mark.parametrize("b,cs,ws", TWIN_CASES)
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


@pytest.mark.parametrize("b,cs,ws", TWIN_CASES)
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


@pytest.mark.parametrize("b,cs,ws", TWIN_CASES)
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


@pytest.mark.parametrize("most", [None, 8])
@pytest.mark.parametrize("cs,ws", GEOMETRY_SHAPES)
@pytest.mark.parametrize("b", GEOMETRY_BATCHES)
def test_read_bwd_launch_geometry(b, cs, ws, most, monkeypatch):
    """The read backward's cluster geometry: the ws rows of gwx and tmp (and
    of the dp the CTA forms) and the cs rows of d_img split over the
    cluster, d_img beside the dW chains where they fit, each output written
    once, the CTA's layout within the card's shared memory, the bulk path at
    every shape but the odd one; also with clusters of up to 8 (``most``),
    as scripts/sweep_st_geometry.py runs them."""
    from tests.test_torch_st_fused import check_cluster_geometry
    if most:
        monkeypatch.setattr(cluster, "MAX_CLUSTER", most)
    geo = st_inline.read_bwd_geometry(b, cs, ws)
    side = check_cluster_geometry(
        geo, b, ws, cs, [[("rows", cs)], [("out", cs), ("chains", 4)]])
    if (b, cs, ws, most) == (64, 50, 28, None):   # 192 + 64 threads
        assert side and geo.threads == 256
    assert geo.smem_bytes == 4 * st_inline._read_bwd_smem_floats(cs, ws,
                                                                 geo.rows)
    assert geo.bulk == ((cs, ws) != (21, 7))


def test_read_bwd_refuses_a_cta_that_does_not_fit():
    """Off the CPU the read backward computes its geometry before it builds
    or launches anything: a 250 x 250 image (250 KB) does not fit one CTA's
    shared memory."""
    b, cs, ws, dev = 1, 250, 28, "meta"
    s = torch.empty((b,), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.attention_read_bwd(torch.empty((b, cs, cs), device=dev),
                                     torch.empty((b, ws, ws), device=dev),
                                     s, s, s, s)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.read_bwd_geometry(b, cs, ws)


def _two_tap_row(p, in_dim):
    """A hat-matrix row as the read backward kernel forms it: zeros, then
    relu(1 - |p - j|) at j = floor(p) and floor(p) + 1 where they lie in
    [0, in_dim), all in float32."""
    row = torch.zeros(in_dim, dtype=torch.float32)
    j0 = torch.floor(p)
    for tap in (0, 1):
        jf = j0 + tap
        if 0 <= float(jf) < in_dim:
            j = int(jf)
            row[j] = torch.clamp(1.0 - torch.abs(p - float(j)), min=0.0)
    return row


@pytest.mark.parametrize("in_dim", [50, 21])
def test_two_tap_rows_are_the_dense_hat_rows(in_dim):
    """The kernel's two taps per row give the dense hat matrix bit for bit:
    rows of _axis_weight_matrix at scales of both signs (so positions rise
    or fall along the rows) and shifts that push rows off either edge, and
    single positions on and one ulp beside integers, at the edges and
    outside the image."""
    out_dim = 28
    a = torch.tensor([-2.5, -1.0, -0.3, 0.0, 0.3, 1.0, 2.5],
                     dtype=torch.float32)
    c = torch.tensor([0.1, -0.9, 0.7, -0.2, 1.3, 0.0, -1.6],
                     dtype=torch.float32)
    dense = _axis_weight_matrix(a, c, out_dim, in_dim)
    p = _pixel_coords(a[:, None] * _linspace(out_dim, "cpu")[None, :]
                      + c[:, None], in_dim)
    for b in range(len(a)):
        for i in range(out_dim):
            assert torch.equal(_two_tap_row(p[b, i], in_dim), dense[b, i])
    f32 = np.float32
    points = [f32(v) for v in (-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 7.0,
                               in_dim - 2, in_dim - 1.5, in_dim - 1, in_dim,
                               in_dim + 0.5)]
    points += [np.nextafter(v, f32(d)) for v in points
               for d in (-np.inf, np.inf)]
    j = torch.arange(in_dim, dtype=torch.float32)
    for v in points:
        pv = torch.tensor(v, dtype=torch.float32)
        want = torch.clamp(1.0 - torch.abs(pv - j), min=0.0)
        assert torch.equal(_two_tap_row(pv, in_dim), want), float(v)


def _fwd_outputs(geo, n):
    """How often the forward kernels' blocks of one image write each output
    of [n, n], mirroring st_inline.cu:two_tap_band: block ``band`` owns rows
    [band * rows, ...), thread t its items t, t + threads, ..., item ``it``
    the outputs (i, l .. l + vec - 1) with i = it // (n / vec),
    l = (it % (n / vec)) * vec."""
    counts = np.zeros((n, n), dtype=np.int64)
    per_row = n // geo.vec
    for band in range(geo.bands):
        r0 = band * geo.rows
        rb = min(geo.rows, n - r0)
        for t in range(geo.threads):
            for it in range(t, rb * per_row, geo.threads):
                i, l = it // per_row, (it % per_row) * geo.vec
                counts[r0 + i, l:l + geo.vec] += 1
    return counts


# STAGE_ITEMS as the wrappers take it, and forcing every launch to stage
# or none (as scripts/sweep_st_geometry.py and the card test do)
ALWAYS, NEVER = 0, 1 << 30


@pytest.mark.parametrize("stage_items", [None, ALWAYS, NEVER])
@pytest.mark.parametrize("direction", ["read", "write"])
@pytest.mark.parametrize("cs,ws", GEOMETRY_SHAPES)
@pytest.mark.parametrize("b", GEOMETRY_BATCHES)
def test_forward_launch_geometry(b, cs, ws, direction, stage_items,
                                 monkeypatch):
    """The forward kernels' bands: FILL_BLOCKS blocks where the output rows
    allow, bands that cover the output rows once, every output written by
    exactly one thread item, float2 items where the width is even, the
    input staged where a thread loops over STAGE_ITEMS items or more, the
    block's taps (and, staged, the whole input) within the card's shared
    memory, the bulk copy where the input is a multiple of 16 bytes."""
    if stage_items is not None:
        monkeypatch.setattr(st_inline, "STAGE_ITEMS", stage_items)
    in_dim, n = (cs, ws) if direction == "read" else (ws, cs)
    geo = st_inline.fwd_geometry(b, in_dim, n, direction)
    items = geo.rows * n // geo.vec
    stage = -(-items // geo.threads) >= st_inline.STAGE_ITEMS
    assert b * geo.bands >= min(st_inline.FILL_BLOCKS, b * n)
    assert geo.bands * geo.rows >= n > (geo.bands - 1) * geo.rows >= 0
    assert geo.vec == (2 if n % 2 == 0 else 1)
    assert geo.threads % 32 == 0
    assert 32 <= geo.threads <= st_inline.MAX_FWD_THREADS
    assert geo.threads >= min(st_inline.MAX_FWD_THREADS,
                              geo.rows * n // geo.vec)
    assert geo.smem_bytes == 4 * (4 * (geo.rows + n)
                                  + (in_dim * in_dim if stage else 0))
    assert geo.smem_bytes <= build.MAX_SMEM_BYTES
    assert geo.stage == stage
    assert geo.bulk == (stage and (cs, ws) != (21, 7))
    np.testing.assert_array_equal(_fwd_outputs(geo, n), 1)


def test_forward_refuses_a_block_that_does_not_fit(monkeypatch):
    """Off the CPU the forward wrappers compute their geometry before they
    build or launch anything: staged, a 250 x 250 input (250 KB) does not
    fit one block's shared memory."""
    monkeypatch.setattr(st_inline, "STAGE_ITEMS", ALWAYS)
    b, big, small, dev = 1, 250, 28, "meta"
    s = torch.empty((b,), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.attention_read_fwd(torch.empty((b, big, big), device=dev),
                                     s, s, s, s, small)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.write_accumulate_fwd(
            torch.empty((b, small, small), device=dev),
            torch.empty((b, big, big), device=dev), s, s, s, s, s)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.fwd_geometry(b, big, small, "read")
    monkeypatch.setattr(st_inline, "STAGE_ITEMS", NEVER)
    assert st_inline.fwd_geometry(b, big, small, "read").smem_bytes < 1024


def _clamped_taps(p, in_dim):
    """A hat row as the forward kernels keep it (st_inline.cu:two_taps), all
    in float32: (j, w0, w1), the row being w0 at column j, w1 at j + 1 and 0
    elsewhere; the taps floor(p) and floor(p) + 1 where they lie in
    [0, in_dim), weighted relu(1 - |p - j|) with fmaxf's NaN rule, and j the
    first tap clamped into [0, in_dim - 2] (0 for a NaN p)."""
    f = float(torch.floor(p))
    j = 0 if f != f else int(min(max(f, 0.0), in_dim - 2))
    w = [torch.zeros((), dtype=torch.float32) for _ in range(2)]
    for tap in (0, 1):
        jf = f + tap
        if 0 <= jf < in_dim:
            w[int(jf) - j] = torch.fmax(1.0 - torch.abs(p - jf),
                                        torch.zeros(()))
    return j, w[0], w[1]


def _tap_row(p, in_dim):
    j, w0, w1 = _clamped_taps(p, in_dim)
    assert 0 <= j <= in_dim - 2
    row = torch.zeros(in_dim, dtype=torch.float32)
    row[j], row[j + 1] = w0, w1
    return row


@pytest.mark.parametrize("out_dim", [28, 27])
@pytest.mark.parametrize("in_dim", [50, 28, 21])
def test_forward_taps_are_the_dense_hat_rows(in_dim, out_dim):
    """The forward kernels' (j, w0, w1) give the dense hat row bit for bit:
    rows of _axis_weight_matrix at scales of both signs and shifts that push
    rows off either edge, infinite and huge scales (rows at +-inf, +-1e30 x
    kpix and, with an odd out_dim, a NaN middle row) and NaN shifts; and
    single positions on and one ulp beside integers, at the edges and
    outside the image, NaN, +-inf and +-1e30. Where p is NaN the plain
    version's row is NaN and the kernels' row is 0, as their dense chains'
    fmaxf gave before."""
    inf, nan = float("inf"), float("nan")
    a = torch.tensor([-2.5, -1.0, -0.3, 0.0, 0.3, 1.0, 2.5, 10.0, inf, -inf,
                      1e30, -1e30, 0.5], dtype=torch.float32)
    c = torch.tensor([0.1, -0.9, 0.7, -0.2, 1.3, 0.0, -1.6, -3.0, 0.0, 0.2,
                      0.0, 0.5, nan], dtype=torch.float32)
    dense = _axis_weight_matrix(a, c, out_dim, in_dim)
    p = _pixel_coords(a[:, None] * _linspace(out_dim, "cpu")[None, :]
                      + c[:, None], in_dim)
    assert bool(torch.isnan(p).any()) and bool(torch.isinf(p).any())
    for b in range(len(a)):
        for i in range(out_dim):
            row = dense[b, i]
            assert bool(torch.isnan(row).all()) == bool(torch.isnan(p[b, i]))
            assert torch.equal(_tap_row(p[b, i], in_dim),
                               torch.nan_to_num(row, nan=0.0))
    f32 = np.float32
    points = [f32(v) for v in (-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 7.0,
                               in_dim - 2, in_dim - 1.5, in_dim - 1, in_dim,
                               in_dim + 0.5)]
    points += [np.nextafter(v, f32(d)) for v in points
               for d in (-np.inf, np.inf)]
    points += [f32(v) for v in (np.nan, np.inf, -np.inf, 1e30, -1e30)]
    j = torch.arange(in_dim, dtype=torch.float32)
    for v in points:
        pv = torch.tensor(v, dtype=torch.float32)
        want = torch.clamp(1.0 - torch.abs(pv - j), min=0.0)
        assert torch.equal(_tap_row(pv, in_dim),
                           torch.nan_to_num(want, nan=0.0)), float(v)


@pytest.mark.parametrize("rows", [1, 3, 10, 28])
def test_band_taps_lie_between_its_end_rows(rows):
    """What the staged forward path relies on: positions are monotone in the
    row index, so every tap with a non-zero weight of a band of rows lies in
    X's rows [min(j_first, j_last), max(j_first, j_last) + 2) of the band's
    end rows, at scales of both signs and shifts off either edge."""
    in_dim, out_dim = 50, 28
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(np.concatenate([
        rng.uniform(-3.0, 3.0, 40), [0.0, 1e-7, -1e-7, 10.0, -10.0]]).astype(
            np.float32))
    c = torch.from_numpy(rng.uniform(-2.5, 2.5, len(a)).astype(np.float32))
    p = _pixel_coords(a[:, None] * _linspace(out_dim, "cpu")[None, :]
                      + c[:, None], in_dim)
    for b in range(len(a)):
        for r0 in range(0, out_dim, rows):
            band = range(r0, min(out_dim, r0 + rows))
            ends = [_clamped_taps(p[b, i], in_dim)[0]
                    for i in (band[0], band[-1])]
            lo, hi = min(ends), max(ends) + 2
            for i in band:
                j, w0, w1 = _clamped_taps(p[b, i], in_dim)
                assert lo <= j <= hi - 2 or float(w0) == float(w1) == 0.0


def _edge_scalars(d):
    """Overwrite the first entries of (s, x, y) with scales and shifts that
    push rows off both edges and the write's largest magnification (s 0.1),
    as many as the batch holds."""
    edges = np.array([[0.1, -1.0, 1.0], [0.1, 1.0, -1.0], [1.0, 1.0, -1.0],
                      [1.0, -1.0, 1.0], [1.0, 0.0, 0.0], [0.1, 0.0, 0.0]],
                     dtype=np.float32)
    k = min(len(d["s"]), len(edges))
    for col, name in enumerate(("s", "x", "y")):
        d[name][:k] = edges[:k, col]
    return d


@pytest.mark.gpu
def test_forward_kernels_match_plain_on_the_card(monkeypatch):
    """Kernels 1 and 2 against their plain versions at B = 1, 7, 64 and 256
    on every card shape ((21, 7) takes float2-less items and the 4-byte
    copies, the others compile-time or run-time sizes), with rows off both
    edges and s = 0.1, read through the cache and staged, and with inputs
    at an odd float offset (no float2, no bulk copy). One launch per call;
    the input canvas is left as it was; a geometry the kernel cannot run is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    for stage in (NEVER, ALWAYS):
        monkeypatch.setattr(st_inline, "STAGE_ITEMS", stage)
        for b in CARD_BATCHES:
            for cs, ws in CARD_SHAPES:
                d = _torch(_edge_scalars(_inputs(b, cs, ws, seed=70 + b)),
                           "cuda")
                read_s, write_s = _scalar_inputs(d)
                canvas = d["canvas"].reshape(b, cs, cs)
                windows = d["windows"].reshape(b, ws, ws)
                shifted = {k: torch.cat([torch.zeros(1, device="cuda"),
                                         v.flatten()])[1:].view(v.shape)
                           for k, v in (("img", d["images"]),
                                        ("canvas", canvas),
                                        ("win", windows))}
                for img, can, win in ((d["images"], canvas, windows),
                                      (shifted["img"], shifted["canvas"],
                                       shifted["win"])):
                    kept = can.clone()
                    st_inline.reset_launches()
                    got_r = st_inline.attention_read_fwd(img, *read_s, ws)
                    got_w = st_inline.write_accumulate_fwd(
                        can, win, *write_s, d["coeff"])
                    torch.cuda.synchronize()
                    assert st_inline.LAUNCHES["inline_attention_read"] == 1
                    assert st_inline.LAUNCHES["inline_write_accumulate"] == 1
                    torch.testing.assert_close(
                        got_r, st_inline.attention_read_fwd_plain(
                            img, *read_s, ws), **TOL)
                    torch.testing.assert_close(
                        got_w, st_inline.write_accumulate_fwd_plain(
                            can, win, *write_s, d["coeff"]), **TOL)
                    assert torch.equal(can, kept), (stage, b, cs, ws)
    # threads beyond the kernel's __launch_bounds__: refused, nothing runs
    d = _torch(_inputs(1, 50, 28, seed=1), "cuda")
    out = torch.empty((1, 28, 28), device="cuda")
    geo = st_inline.fwd_geometry(1, 50, 28, "read")
    args = list(st_inline._fwd_launch_args(geo, d["images"], out))
    args[2] = 2 * st_inline.MAX_FWD_THREADS
    with pytest.raises(RuntimeError, match="launch failed"):
        build.launch(st_inline._lib().st_inline_read, d["images"].device,
                     d["images"], d["s"], d["y"], d["s"], d["x"], out, 1, 50,
                     28, *args)


def _shifted(t):
    """``t``'s values at an odd float offset: neither 8- nor 16-byte
    aligned, so no float2 item and no bulk copy."""
    return torch.cat([torch.zeros(1, device=t.device),
                      t.flatten()])[1:].view(t.shape)


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(monkeypatch):
    """Build the CUDA kernels, launch each on the card and hold it against
    its plain version; every launch is counted. The read backward also at
    B = 1, 7, 64 and 256, cs 100 and the odd shape (21, 7) that takes its
    4-byte copy path, and in clusters of 8; the write backward at the same
    batches and shapes with rows off both edges and s = 0.1, and at an odd
    float offset. A geometry the write backward cannot run is refused."""
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
    # the read backward's cluster geometries: B = 1 to 256 (clusters of 2
    # and 1, and of 8 as the sweep runs them), cs 100, and (21, 7) on the
    # 4-byte copy path
    cases = [(b, cs, ws, None) for b in CARD_BATCHES
             for cs, ws in CARD_SHAPES]
    cases += [(b, cs, ws, 8) for b in (1, 7) for cs, ws in CARD_SHAPES]
    for b, cs, ws, most in cases:
        if most:
            monkeypatch.setattr(cluster, "MAX_CLUSTER", most)
        d = _torch(_inputs(b, cs, ws, seed=60 + b), "cuda")
        g_read = torch.from_numpy(_cotangents(b, cs, ws, 60 + b)[0]).cuda()
        read_s, _ = _scalar_inputs(d)
        st_inline.reset_launches()
        got = st_inline.attention_read_bwd(d["images"], g_read, *read_s)
        torch.cuda.synchronize()
        want = st_inline.attention_read_bwd_plain(d["images"], g_read,
                                                  *read_s)
        torch.testing.assert_close(got[0], want[0], **TOL)
        for gg, ww in zip(got[1:], want[1:]):
            err = (gg - ww).abs() / ww.abs().clamp(min=1.0)
            assert float(err.max()) <= 1e-4, (b, cs, ws, most)
        assert st_inline.LAUNCHES["inline_attention_read_bwd"] == 1
    # the write backward: inputs aligned and at an odd float offset (the
    # 4-byte copies, as (21, 7) always takes)
    for b in CARD_BATCHES:
        for cs, ws in CARD_SHAPES:
            d = _torch(_edge_scalars(_inputs(b, cs, ws, seed=80 + b)), "cuda")
            g = torch.from_numpy(_cotangents(b, cs, ws, 80 + b)[1])
            g = g.cuda().reshape(b, cs, cs)
            _, write_s = _scalar_inputs(d)
            win = d["windows"].reshape(b, ws, ws)
            for w_in, g_in in ((win, g), (_shifted(win), _shifted(g))):
                st_inline.reset_launches()
                got = st_inline.write_accumulate_bwd(w_in, g_in, *write_s,
                                                     d["coeff"])
                torch.cuda.synchronize()
                assert st_inline.LAUNCHES["inline_write_accumulate_bwd"] == 1
                want = st_inline.write_accumulate_bwd_plain(
                    w_in, g_in, *write_s, d["coeff"])
                case = (b, cs, ws, w_in.data_ptr() % 16)
                assert float((got[0] - want[0]).abs().max()) <= 1e-5, case
                for gg, ww in zip(got[1:], want[1:]):
                    err = (gg - ww).abs() / ww.abs().clamp(min=1.0)
                    assert float(err.max()) <= 1e-4, case
    # threads beyond the kernel's __launch_bounds__, or shared memory beyond
    # the card's: refused, nothing runs
    d = _torch(_inputs(1, 50, 28, seed=1), "cuda")
    _, write_s = _scalar_inputs(d)
    win, g = d["windows"].reshape(1, 28, 28), d["images"]
    d_win, d_s = torch.empty_like(win), torch.empty((5, 1), device="cuda")
    geo = st_inline.write_bwd_geometry(50, 28)
    for threads, smem in ((2 * cluster.MAX_THREADS, geo.smem_bytes),
                          (geo.threads, build.MAX_SMEM_BYTES + 16)):
        with pytest.raises(RuntimeError, match="launch failed"):
            build.launch(st_inline._lib().st_inline_write_bwd, win.device, win,
                         g, *write_s, d["coeff"], d_win, *d_s, 1, 50, 28,
                         threads, smem, 0)


# -------------------- the write backward (kernel 4) --------------------------

def _fma(a, b, c):
    """fmaf(a, b, c) on float32 tensors: the product exact in float64, the
    sum rounded to float32 (through float64). A term whose weight is +0
    leaves an accumulator other than -0 as it is, exactly as fmaf does,
    which is what the chains below rely on."""
    return (a.double() * b.double() + c.double()).float()


def _tap_columns(p, in_dim):
    """Columns of the two taps of each position, as st_inline.cu:tap_column
    forms them: floorf(p) + tap compared in float32 before the cast, so a
    NaN, an infinite or a far-off position has none. [..., 2] int64, -1
    where the tap lies outside [0, in_dim)."""
    jf = torch.floor(p)[..., None] + torch.tensor([0.0, 1.0])
    ok = (jf >= 0) & (jf < in_dim)
    return torch.where(ok, torch.nan_to_num(jf, nan=-1.0, posinf=-1.0,
                                            neginf=-1.0), -1.0).long()


def _column_ranges(p, in_dim):
    """Each column's row range of the hat matrix with row positions p
    [B, out], as the write backward forms it: the least and the greatest row
    whose taps include the column; (out, -1) where no row's do."""
    b, out_dim = p.shape
    lo = torch.full((b, in_dim), out_dim, dtype=torch.long)
    hi = torch.full((b, in_dim), -1, dtype=torch.long)
    cols = _tap_columns(p, in_dim)
    for i in range(out_dim):
        for tap in (0, 1):
            j = cols[:, i, tap]
            for bb in torch.nonzero(j >= 0).flatten().tolist():
                jj = int(j[bb])
                lo[bb, jj] = min(int(lo[bb, jj]), i)
                hi[bb, jj] = max(int(hi[bb, jj]), i)
    return lo, hi


def _write_scalars():
    """(a, c) of one axis of the write (a = 1/s): the model's range of s
    (0.1 to 1) with shifts that push rows off both edges, a <= 0, tiny a (one
    column's range is every row), NaN and +-inf in either scalar."""
    inf, nan = float("inf"), float("nan")
    s = np.array([0.1, 0.1, 0.25, 0.5, 1.0, 1.0, 0.7], dtype=np.float32)
    x = np.array([-1.0, 1.0, 0.3, -0.8, 1.0, -1.0, 0.0], dtype=np.float32)
    a = list(1.0 / s) + [0.0, 1e-6, -1.0, -3.0, nan, 1.0, inf, -inf, 2.0]
    c = list(-x / s) + [0.2, -0.1, 0.5, 0.0, 0.0, nan, 0.0, 0.1, inf]
    return (torch.tensor(a, dtype=torch.float32),
            torch.tensor(c, dtype=torch.float32))


def _write_positions(a, c, out_dim, in_dim):
    return _pixel_coords(a[:, None] * _linspace(out_dim, "cpu")[None, :]
                         + c[:, None], in_dim)


def _kernel_hat(p, in_dim):
    """The kernels' dense hat matrix [B, out, in]: fmaxf(0, 1 - |p - j|),
    0 where p is NaN."""
    j = torch.arange(in_dim, dtype=torch.float32)
    return torch.fmax(1.0 - torch.abs(p[..., None] - j), torch.zeros(()))


@pytest.mark.parametrize("in_dim,out_dim", [(28, 50), (7, 21)])
def test_column_ranges_hold_every_tapping_row(in_dim, out_dim):
    """The write backward's column ranges against the non-zero rows of each
    column of _axis_weight_matrix (rows [out] over columns [in]): every row
    with a non-zero weight lies in its column's range, whose end rows tap
    the column; NaN rows (the plain version's, where a position is NaN) tap
    nothing. At the model's scales (a = 1/s >= 1, finite) positions advance
    by at least (in - 1.001) / (out - 1) per row, so a range spans at
    most 2 / that + 1 rows: 4 at the model's shapes (28, 50)."""
    a, c = _write_scalars()
    dense = _axis_weight_matrix(a, c, out_dim, in_dim)
    p = _write_positions(a, c, out_dim, in_dim)
    lo, hi = _column_ranges(p, in_dim)
    cols = _tap_columns(p, in_dim)
    most = int(2.0 / ((in_dim - 1.001) / (out_dim - 1))) + 1
    assert most == 4 or (in_dim, out_dim) != (28, 50)
    for b in range(len(a)):
        for k in range(in_dim):
            rows = torch.nonzero(torch.nan_to_num(dense[b, :, k], nan=0.0))
            for i in rows.flatten().tolist():
                assert lo[b, k] <= i <= hi[b, k], (b, k, i)
            if lo[b, k] <= hi[b, k]:
                for end in (int(lo[b, k]), int(hi[b, k])):
                    assert k in cols[b, end].tolist(), (b, k, end)
                if 1.0 <= float(a[b]) < float("inf"):
                    assert hi[b, k] - lo[b, k] + 1 <= most, (b, k)
            else:
                assert not bool((cols[b] == k).any())
    assert bool((lo > hi).all(1)[torch.isnan(a) | torch.isinf(a)].all())
    tiny = int(torch.nonzero(a == 1e-6)[0])
    assert int((hi[tiny] - lo[tiny] + 1).max()) == out_dim


def _range_chain(w, x, lo, hi):
    """out[b, r, k] = the fmaf chain over t in [lo[b, k], hi[b, k]],
    ascending, of w[b, r, t] * x[b, t, k]; 0 where the range is empty (how
    the write backward forms gwx over Wx's column ranges)."""
    acc = torch.zeros(w.shape[0], w.shape[1], x.shape[2])
    for t in range(w.shape[2]):
        inside = ((lo <= t) & (t <= hi))[:, None, :]
        acc = torch.where(inside, _fma(w[:, :, t, None], x[:, None, t, :],
                                       acc), acc)
    return acc


def _dense_chain(w, x):
    acc = torch.zeros(w.shape[0], w.shape[1], x.shape[2])
    for t in range(w.shape[2]):
        acc = _fma(w[:, :, t, None], x[:, None, t, :], acc)
    return acc


@pytest.mark.parametrize("cs,ws", [(50, 28), (21, 7)])
def test_range_chains_are_the_dense_chains(cs, ws):
    """The write backward's chains give the dense chains' bits on finite
    inputs (signed, with exact zeros), over hat matrices at every scale of
    _write_scalars: gwx = g @ Wx over Wx's column ranges, d_win's sum
    Wy^T gwx over Wy's, and tmp = Wy @ win from the two taps of each row
    (fmaf(w1, win[j + 1], fmaf(w0, win[j], 0)), st_inline.cu:two_taps)."""
    ay, cy = _write_scalars()
    ax, cx = ay.flip(0), cy.roll(3)
    b = len(ay)
    rng = np.random.default_rng(cs)
    g = torch.from_numpy(rng.standard_normal((b, cs, cs)).astype(np.float32))
    win = torch.from_numpy(rng.uniform(-1.0, 1.0, (b, ws, ws)).astype(
        np.float32))
    g[:, ::7, ::5] = 0.0
    win[:, ::3, ::4] = 0.0
    py = _write_positions(ay, cy, cs, ws)
    px = _write_positions(ax, cx, cs, ws)
    wy, wx = _kernel_hat(py, ws), _kernel_hat(px, ws)      # [B, cs, ws]
    bits = lambda t: t.view(torch.int32)                   # noqa: E731
    lo_x, hi_x = _column_ranges(px, ws)
    gwx = _range_chain(g, wx, lo_x, hi_x)
    assert torch.equal(bits(gwx), bits(_dense_chain(g, wx)))
    # d_win[j, k] = sum_i Wy[i, j] gwx[i, k], over the range of Wy's column
    # j: a range by output row
    lo_y, hi_y = _column_ranges(py, ws)
    d_win = torch.zeros(b, ws, ws)
    for t in range(cs):
        inside = ((lo_y <= t) & (t <= hi_y))[:, :, None]
        d_win = torch.where(inside, _fma(wy[:, t, :, None], gwx[:, None, t, :],
                                         d_win), d_win)
    assert torch.equal(bits(d_win),
                       bits(_dense_chain(wy.transpose(1, 2), gwx)))
    tmp = torch.zeros(b, cs, ws)
    for bb in range(b):
        for i in range(cs):
            j, w0, w1 = _clamped_taps(py[bb, i], ws)
            tmp[bb, i] = _fma(w1, win[bb, j + 1], _fma(w0, win[bb, j],
                                                       torch.zeros(ws)))
    assert torch.equal(bits(tmp), bits(_dense_chain(wy, win)))


def _write_bwd_outputs(geo, cs, ws):
    """What one image's CTA stores, mirroring
    st_inline.cu:st_write_bwd_kernel: how often it stores each element of
    gwx and of tmp [cs, ws] (phase 1: items of GWX_ROWS rows band + r * bands
    of one column k, and of one row by TMP_COLS columns q + c * qn), each
    element of d_win [ws, ws] (phase 2: one row j by DWIN_COLS columns) and
    each row's dp (axis, row), with the thread ranges of st_cluster.cuh's
    Split."""
    from tests.test_torch_st_fused import _split
    gwx = np.zeros((cs, ws), dtype=np.int64)
    tmp = np.zeros_like(gwx)
    d_win = np.zeros((ws, ws), dtype=np.int64)
    dp = np.zeros((2, cs), dtype=np.int64)
    bands = -(-cs // st_inline.GWX_ROWS)
    tq = -(-ws // st_inline.TMP_COLS)
    (t0, nt0), (t1, nt1) = _split(geo.threads, bands * ws, cs * tq)
    assert t0 + nt0 <= geo.threads and t1 + nt1 <= geo.threads
    for t in range(nt0):
        for it in range(t, bands * ws, nt0):
            band, k = divmod(it, ws)
            for r in range(st_inline.GWX_ROWS):
                if band + r * bands < cs:
                    gwx[band + r * bands, k] += 1
    for t in range(nt1):
        for it in range(t, cs * tq, nt1):
            i, q = divmod(it, tq)
            for c in range(st_inline.TMP_COLS):
                if q + c * tq < ws:
                    tmp[i, q + c * tq] += 1
    dq = -(-ws // st_inline.DWIN_COLS)
    yspan = 32 * -(-cs // 32)
    (t0, nt0), (t1, nt1) = _split(geo.threads, ws * dq, 2 * yspan)
    assert t0 + nt0 <= geo.threads and t1 + nt1 <= geo.threads
    for t in range(nt0):
        for it in range(t, ws * dq, nt0):
            j, q = divmod(it, dq)
            for c in range(st_inline.DWIN_COLS):
                if q + c * dq < ws:
                    d_win[j, q + c * dq] += 1
    # the 32 items a warp takes at once are rows of one axis: y rows
    # [0, yspan), x rows [yspan, 2 yspan), whole warps each
    assert t1 % 32 == 0 and nt1 % 32 == 0
    for t in range(nt1):
        for item in range(t, 2 * yspan, nt1):
            axis, i = divmod(item, yspan)
            if i < cs:
                dp[axis, i] += 1
    return gwx, tmp, d_win, dp


@pytest.mark.parametrize("cs,ws", GEOMETRY_SHAPES)
def test_write_bwd_launch_geometry(cs, ws):
    """The write backward's geometry, one CTA per image: every element of
    gwx, tmp and d_win stored once and every row's dp formed once; the
    products side by side at the model's shapes; the CTA's layout within the
    card's shared memory; the bulk path at every shape but the odd one."""
    geo = st_inline.write_bwd_geometry(cs, ws)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= cluster.MAX_THREADS
    for formed in _write_bwd_outputs(geo, cs, ws):
        np.testing.assert_array_equal(formed, 1)
    if (cs, ws) == (50, 28):
        # gwx's 112 items beside tmp's 100; d_win's 112 beside 2 x 64 rows'
        # dp, on all 256 threads
        assert geo.threads == 256
        assert st_inline._write_bwd_phases(cs, ws) == [(112, 100), (112, 128)]
    assert geo.smem_bytes == 4 * st_inline._write_bwd_smem_floats(cs, ws)
    assert geo.smem_bytes <= build.MAX_SMEM_BYTES
    assert geo.bulk == ((cs, ws) != (21, 7))


def test_write_bwd_refuses_a_cta_that_does_not_fit():
    """Off the CPU the write backward computes its geometry before it builds
    or launches anything: a 250 x 250 canvas cotangent (250 KB) does not fit
    one CTA's shared memory."""
    b, cs, ws, dev = 1, 250, 28, "meta"
    s = torch.empty((b,), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.write_accumulate_bwd(torch.empty((b, ws, ws), device=dev),
                                       torch.empty((b, cs, cs), device=dev),
                                       s, s, s, s, s)
    with pytest.raises(ValueError, match="shared memory"):
        st_inline.write_bwd_geometry(cs, ws)


def _warp_tree(x):
    """The xor-shuffle sum of 32 float32 lanes (every lane ends with it)."""
    for off in (16, 8, 4, 2, 1):
        x = (x + x[np.arange(32) ^ off]).astype(np.float32)
    return x[0]


def _block_sum(lanes):
    """A 256-thread block_sum of one value per thread: the warps' trees,
    then the 8 warps' sums in order from 0."""
    total = np.float32(0.0)
    for w in range(8):
        total = np.float32(total + _warp_tree(lanes[32 * w:32 * (w + 1)]))
    return total


@pytest.mark.parametrize("cs,ws", GEOMETRY_SHAPES)
def test_write_bwd_scalars_keep_the_256_thread_order(cs, ws):
    """The CTA's five sums as st_cluster.cuh:lane_tree_sums forms them
    on the geometry's thread count (thread v0 computes virtual lanes v0,
    v0 + threads, ..., warp w0 reduces rows w0, w0 + warps, ... of 32 lanes
    of every sum, thread 0 adds each sum's 8 rows in order) give the bits of
    the one-block kernel's 256 threads: d_coeff's lane t an fmaf chain of
    tmp * gwx over the row-major elements t, t + 256, ..., each axis's lane t
    the chains over rows t, t + 256, ... of t_i * dp_i and dp_i."""
    geo = st_inline.write_bwd_geometry(cs, ws)
    rng = np.random.default_rng(cs)
    tmp, gwx = (torch.from_numpy(rng.standard_normal(cs * ws).astype(
        np.float32)) for _ in range(2))
    dp = torch.from_numpy(rng.standard_normal((2, cs)).astype(np.float32))
    t = _linspace(cs, "cpu")

    def lane(v):
        x = []
        for axis in range(2):
            ta = tc = torch.zeros(())
            for i in range(v, cs, cluster.LANES):
                ta = _fma(t[i], dp[axis, i], ta)
                tc = (tc + dp[axis, i]).float()
            x += [ta, tc]
        dco = torch.zeros(())
        for idx in range(v, cs * ws, cluster.LANES):
            dco = _fma(tmp[idx], gwx[idx], dco)
        return np.array([float(v) for v in x + [dco]], dtype=np.float32)

    k = 5
    lanes = np.zeros((k, cluster.LANES), dtype=np.float32)
    seen = np.zeros(cluster.LANES, dtype=np.int64)
    for v0 in range(geo.threads):
        for v in range(v0, cluster.LANES, geo.threads):
            lanes[:, v] = lane(v)
            seen[v] += 1
    np.testing.assert_array_equal(seen, 1)
    rows = lanes.reshape(k * cluster.LANES // 32, 32)
    red = np.zeros(len(rows), dtype=np.float32)
    reduced = np.zeros(len(rows), dtype=np.int64)
    warps = geo.threads // 32
    for w0 in range(warps):
        for w in range(w0, cluster.LANES // 32, warps):
            for sm in range(k):
                row = sm * cluster.LANES // 32 + w
                red[row] = _warp_tree(rows[row])
                reduced[row] += 1
    np.testing.assert_array_equal(reduced, 1)
    got = []
    for s in range(k):
        total = np.float32(0.0)
        for w in range(cluster.LANES // 32):
            total = np.float32(total + red[s * cluster.LANES // 32 + w])
        got.append(total)
    # the one-block kernel: thread t of 256 holds lane t's chains
    old = np.stack([lane(v) for v in range(cluster.LANES)], axis=1)
    want = [_block_sum(old[s]) for s in range(k)]
    assert np.array_equal(np.array(got).view(np.int32),
                          np.array(want).view(np.int32))
    # the small shapes take fewer than 256 threads: a map not the identity
    assert geo.threads < cluster.LANES or cs > 30
