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


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(monkeypatch):
    """Build the CUDA kernels, launch each on the card and hold it against
    its plain version; every launch is counted. The read backward also at
    B = 1, 7, 64 and 256, cs 100 and the odd shape (21, 7) that takes its
    4-byte copy path, and in clusters of 8."""
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
