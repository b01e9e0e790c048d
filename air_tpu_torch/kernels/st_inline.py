"""Spatial-transformer attention read and write-accumulate with the bilinear
weights built inside the kernel (hand-written CUDA, ``csrc/st_inline.cu``).

Counterparts of ``air_tpu/kernels/st_inline.py``: ``inline_attention_read``
(TPU kernels ``_rd_fwd_kernel`` and ``_rd_bwd_kernel``) and
``inline_write_accumulate`` (``_wr_fwd_kernel`` and ``_wr_bwd_kernel``).

Each pair of kernels sits behind one ``torch.autograd.Function`` that takes
the per-axis scalars ``(ay, cy, ax, cx)`` (and ``coeff`` for the write) as
tensor inputs, as ``_read_core`` and ``_write_core`` do in the JAX package.
The maps from ``(s, x, y)`` to those scalars stay plain differentiable torch
ops outside the Function, so autograd chains the scalar cotangents back.

On CUDA tensors the Function launches the forward kernel in ``forward`` and
the backward kernel in ``backward``, or raises; on CPU tensors it computes
the plain PyTorch versions beside them, all four in the same (a, c) form:
the forward ``attention_read_fwd_plain`` / ``write_accumulate_fwd_plain``
from ``air_tpu_torch.ops.transformer``'s weight matrices, the backward the
explicit formulas ``attention_read_bwd_plain`` / ``write_accumulate_bwd_plain``
(not autograd through the plain forward). The wrappers raise on a dtype
other than float32, a shape the kernel does not take or tensors on different
devices; a strided input (the model passes column views such as
``shift[:, 0]``) is copied to a contiguous one before the launch. Each
kernel launch adds one to ``LAUNCHES[<name>]``, and nothing else does but
the replay of a captured train step, which adds the launches its capture
counted (``train/fast_pipeline.StepGraph``).

The forward kernels run one block per (image, band of output rows);
``fwd_geometry`` computes the bands. The read backward runs a cluster of
CTAs per image; ``read_bwd_geometry`` (``cluster.geometry``) computes its
split. The write backward runs one CTA per image; ``write_bwd_geometry``
gives its threads and shared memory. The launchers check what they are
given, and the CPU tests reach the geometry here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from air_tpu_torch.kernels import build, cluster
from air_tpu_torch.ops.transformer import (_axis_weight_matrix, _linspace,
                                           separable_transform)

LAUNCHES = {"inline_attention_read": 0, "inline_write_accumulate": 0,
            "inline_attention_read_bwd": 0, "inline_write_accumulate_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("st_inline").lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    for fn, n_ptr, n_int in ((lib.st_inline_read, 6, 10),
                             (lib.st_inline_write, 8, 10),
                             (lib.st_inline_read_bwd, 11, 9),
                             (lib.st_inline_write_bwd, 13, 6)):
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        fn.restype = i32
    return lib


# launch geometry of the forward kernels, as csrc/st_inline.cu takes it
# (both constants from scripts/sweep_st_geometry.py, PERF.md): two blocks
# per SM were as fast as one or faster at B = 1 to 1024; staging the input
# in shared memory paid only where each thread loops over 4 or more items
# (the write at B >= 256), and was slower at 1-2 items
FILL_BLOCKS = 2 * cluster.SMS   # blocks a launch aims for, where rows allow
MAX_FWD_THREADS = 256           # the forward kernels' __launch_bounds__
STAGE_ITEMS = 4                 # items per thread from which X is staged


@dataclasses.dataclass(frozen=True)
class FwdGeometry:
    """One launch of the read or write forward kernel: ``bands`` bands of
    ``rows`` consecutive output rows per image (the last may have fewer),
    one block of ``threads`` threads and ``smem_bytes`` of shared memory per
    band; each thread item writes ``vec`` neighbouring outputs of a row (2
    where the output width is even: float2 loads and stores, which the
    wrapper also needs 8-byte aligned pointers for); ``stage`` when the
    band's rows of the input are copied into shared memory (a thread loops
    over STAGE_ITEMS items or more), ``bulk`` when that copy is one
    16-byte-sized 1-D bulk copy (the wrapper also needs a 16-byte aligned
    input for it)."""
    bands: int
    rows: int
    threads: int
    vec: int
    smem_bytes: int
    stage: bool
    bulk: bool


def fwd_geometry(batch: int, in_dim: int, out_dim: int,
                 name: str) -> FwdGeometry:
    """How a launch of ``out = Wy @ X @ Wx^T`` (X [B, in, in], out [B, out,
    out]; the read and the write alike) splits its work: the fewest bands
    per image that give FILL_BLOCKS blocks where the output rows allow (one
    row per band at most), the rows spread evenly over them; threads for one
    item each, within MAX_FWD_THREADS (the block loops over the rest). The
    block's shared memory holds a 16-byte tap per band row and per column,
    and when staged up to the whole input. Raises if a block does not
    fit."""
    want = min(out_dim, -(-FILL_BLOCKS // batch))
    rows = -(-out_dim // want)
    while rows > 1 and -(-out_dim // rows) < want:
        rows -= 1
    bands = -(-out_dim // rows)
    rows = -(-out_dim // bands)
    vec = 2 if out_dim % 2 == 0 else 1
    items = rows * out_dim // vec
    threads = min(MAX_FWD_THREADS, 32 * -(-items // 32))
    stage = -(-items // threads) >= STAGE_ITEMS
    floats = 4 * (rows + out_dim) + (in_dim * in_dim if stage else 0)
    build.check_smem(name, floats)
    return FwdGeometry(bands, rows, threads, vec, 4 * floats, stage,
                       stage and in_dim * in_dim % 4 == 0)


def _fwd_launch_args(geo: FwdGeometry, x: torch.Tensor, *outputs) -> tuple:
    """The geometry as the launchers take it: float2 items only where every
    output-shaped tensor is 8-byte aligned, the bulk copy only where the
    input is 16-byte aligned."""
    vec = geo.vec if all(t.data_ptr() % 8 == 0 for t in outputs) else 1
    return (geo.bands, geo.rows, geo.threads, geo.smem_bytes, vec,
            int(geo.stage), int(geo.bulk and x.data_ptr() % 16 == 0))


def _read_bwd_smem_floats(cs: int, ws: int, rows: int) -> int:
    """Floats of one read-backward CTA's shared memory, as st_inline.cu's
    ReadBwdLayout: img, g, the dense Wy and Wx, gwx, tmp, the rows'
    positions, dW at the CTA's taps, the dp of all rows, and the four
    scalar reductions' lanes and warp sums; each region on 16 bytes."""
    r4 = cluster.round4
    return (r4(cs * cs) + r4(ws * ws) + 4 * r4(ws * cs) + 2 * r4(ws)
            + 4 * rows + r4(2 * ws) + 4 * cluster.LANES + cluster.LANES // 8)


def read_bwd_geometry(b: int, cs: int, ws: int) -> cluster.ClusterGeometry:
    """Launch geometry of the read backward kernel (``cluster.geometry``):
    the clusters split the ws rows of gwx and tmp [ws, cs] (and with them
    the rows whose dp the CTA forms), and the cs rows of d_img [cs, cs]."""
    return cluster.geometry(
        b, ws, cs, functools.partial(_read_bwd_phases, cs=cs),
        lambda rows: _read_bwd_smem_floats(cs, ws, rows),
        (cs * cs, ws * ws), "inline_attention_read_bwd")


def _read_bwd_phases(rows: int, out_rows: int, cs: int) -> list:
    """The read backward's products: gwx (``rows`` rows of register tiles)
    on the whole block, then d_img (``out_rows`` rows) beside the 4 * rows
    dW chains, all cs wide."""
    return [(cluster.tiles(rows, cs),),
            (cluster.tiles(out_rows, cs), 4 * rows)]


# the write backward's items, as csrc/st_inline.cu takes them (kGwxRows,
# kTmpCols, kDwinCols): gwx rows of one column, tmp and d_win columns of one
# row
GWX_ROWS, TMP_COLS, DWIN_COLS = 13, 14, 8


@dataclasses.dataclass(frozen=True)
class WriteBwdGeometry:
    """One launch of the write backward kernel: one CTA per image of
    ``threads`` threads and ``smem_bytes`` of shared memory; ``bulk`` when
    win and g are each a multiple of 16 bytes (the wrapper also needs
    16-byte aligned pointers for the bulk copies)."""
    threads: int
    smem_bytes: int
    bulk: bool


def _write_bwd_smem_floats(cs: int, ws: int) -> int:
    """Floats of one write-backward CTA's shared memory, as st_inline.cu's
    WriteBwdLayout: win, g, gwx, tmp, the grid and the rows' positions, the
    columns' row ranges, the dp of all rows, and the five scalar reductions'
    lanes and warp sums; each region on 16 bytes."""
    r4 = cluster.round4
    return (r4(ws * ws) + r4(cs * cs) + 2 * r4(cs * ws) + 3 * r4(cs)
            + 4 * ws + r4(2 * cs) + 5 * cluster.LANES
            + 5 * cluster.LANES // 32)


def write_bwd_geometry(cs: int, ws: int) -> WriteBwdGeometry:
    """Launch geometry of the write backward kernel, one CTA per image (a
    cluster of 2 measured slower at every batch, PERF.md): threads enough
    for the wider of its two phases side by side, within
    cluster.MAX_THREADS (a phase that does not fit runs its products one
    after the other, each walking its items in a loop). Raises if a CTA does
    not fit the card's shared memory."""
    threads = min(cluster.MAX_THREADS,
                  max(sum(32 * -(-c // 32) for c in phase)
                      for phase in _write_bwd_phases(cs, ws)))
    floats = _write_bwd_smem_floats(cs, ws)
    build.check_smem("inline_write_accumulate_bwd", floats)
    return WriteBwdGeometry(threads, 4 * floats,
                            cs * cs % 4 == 0 and ws * ws % 4 == 0)


def _write_bwd_phases(cs: int, ws: int) -> list:
    """The write backward's products: gwx (columns by bands of GWX_ROWS
    rows) beside tmp (rows by TMP_COLS columns), then d_win (rows by
    DWIN_COLS columns) beside the dW chains and dp of the cs rows of Wy and
    of Wx, each axis's rows on whole warps of their own."""
    return [(-(-cs // GWX_ROWS) * ws, cs * -(-ws // TMP_COLS)),
            (ws * -(-ws // DWIN_COLS), 2 * 32 * -(-cs // 32))]


# -------------------- plain versions ----------------------------------------

def attention_read_fwd_plain(images, ay, cy, ax, cx, ws: int):
    """Plain PyTorch version of the read kernel: ``Wy(ay, cy) @ images @
    Wx(ax, cx)^T``, [B, cs, cs] -> [B, ws, ws]."""
    return separable_transform(images, ax, ay, cx, cy, (ws, ws))


def write_accumulate_fwd_plain(canvas, windows, ay, cy, ax, cx, coeff):
    """Plain PyTorch version of the write kernel: ``canvas + coeff * (Wy(ay,
    cy) @ windows @ Wx(ax, cx)^T)`` on [B, cs, cs] canvases."""
    cs = canvas.shape[-1]
    return canvas + coeff[:, None, None] * separable_transform(
        windows, ax, ay, cx, cy, (cs, cs))


def _scalar_cotangents(dw, a, c, in_dim: int):
    """Contract a weight cotangent dW [B, out, in] of W(a, c) to (d_a, d_c):
    dp_i = sum_j dW[i, j] * -sign(p_i - j) * 1{|p_i - j| < 1},
    d_a = kpix * sum_i t_i dp_i, d_c = kpix * sum_i dp_i."""
    out_dim = dw.shape[1]
    kpix = (in_dim - 1.001) / 2.0
    t = _linspace(out_dim, dw.device)
    p = (a[:, None] * t + c[:, None] + 1.0) * kpix               # [B, out]
    d = p[..., None] - torch.arange(in_dim, dtype=torch.float32,
                                    device=dw.device)            # [B, out, in]
    dp = (dw * -torch.sign(d) * (torch.abs(d) < 1.0)).sum(-1)    # [B, out]
    return kpix * (t * dp).sum(-1), kpix * dp.sum(-1)


def attention_read_bwd_plain(images, g, ay, cy, ax, cx):
    """Plain PyTorch version of the read backward kernel: from images
    [B, cs, cs] and the output cotangent g [B, ws, ws], returns
    (d_images [B, cs, cs], d_ay, d_cy, d_ax, d_cx [B])."""
    ws, cs = g.shape[-1], images.shape[-1]
    wy = _axis_weight_matrix(ay, cy, ws, cs)             # [B, ws, cs]
    wx = _axis_weight_matrix(ax, cx, ws, cs)
    gwx = torch.bmm(g, wx)                               # [B, ws, cs]
    d_img = torch.bmm(wy.transpose(1, 2), gwx)
    dwy = torch.bmm(gwx, images.transpose(1, 2))         # [B, ws, cs]
    dwx = torch.bmm(g.transpose(1, 2), torch.bmm(wy, images))
    return (d_img, *_scalar_cotangents(dwy, ay, cy, cs),
            *_scalar_cotangents(dwx, ax, cx, cs))


def write_accumulate_bwd_plain(windows, g, ay, cy, ax, cx, coeff):
    """Plain PyTorch version of the write backward kernel: from windows
    [B, ws, ws] and the canvas cotangent g [B, cs, cs], returns
    (d_windows [B, ws, ws], d_ay, d_cy, d_ax, d_cx, d_coeff [B]).
    The canvas's own cotangent is g."""
    cs, ws = g.shape[-1], windows.shape[-1]
    c = coeff[:, None, None]
    wy = _axis_weight_matrix(ay, cy, cs, ws)             # [B, cs, ws]
    wx = _axis_weight_matrix(ax, cx, cs, ws)
    gwx = torch.bmm(g, wx)                               # [B, cs, ws]
    tmp = torch.bmm(wy, windows)                         # [B, cs, ws]
    d_win = c * torch.bmm(wy.transpose(1, 2), gwx)
    dwy = c * torch.bmm(gwx, windows.transpose(1, 2))
    dwx = c * torch.bmm(g.transpose(1, 2), tmp)
    recon = torch.bmm(tmp, wx.transpose(1, 2))
    return (d_win, *_scalar_cotangents(dwy, ay, cy, ws),
            *_scalar_cotangents(dwx, ax, cx, ws),
            (g * recon).sum((1, 2)))


# -------------------- kernels, or their plain versions on the CPU ------------

def attention_read_fwd(images, ay, cy, ax, cx, ws: int) -> torch.Tensor:
    """``Wy(ay, cy) @ images @ Wx(ax, cx)^T`` [B, ws, ws]: the read kernel on
    CUDA tensors, its plain version on CPU tensors."""
    b, cs = images.shape[0], images.shape[-1]
    if images.device.type == "cpu":
        return attention_read_fwd_plain(images, ay, cy, ax, cx, ws)
    geo = fwd_geometry(b, cs, ws, "inline_attention_read")
    images, ay, cy, ax, cx = build.contiguous(images, ay, cy, ax, cx)
    out = torch.empty((b, ws, ws), dtype=torch.float32, device=images.device)
    build.launch(_lib().st_inline_read, images.device, images, ay, cy, ax,
                 cx, out, b, cs, ws, *_fwd_launch_args(geo, images, out))
    LAUNCHES["inline_attention_read"] += 1
    return out


def attention_read_bwd(images, g, ay, cy, ax, cx):
    """(d_images, d_ay, d_cy, d_ax, d_cx) of the read: the backward kernel on
    CUDA tensors, ``attention_read_bwd_plain`` on CPU tensors."""
    b, cs, ws = images.shape[0], images.shape[-1], g.shape[-1]
    build.check("g", g, (b, ws, ws), images.device)
    if images.device.type == "cpu":
        return attention_read_bwd_plain(images, g, ay, cy, ax, cx)
    geo = read_bwd_geometry(b, cs, ws)
    images, g, ay, cy, ax, cx = build.contiguous(images, g, ay, cy, ax, cx)
    d_img = torch.empty_like(images)
    d_s = torch.empty((4, b), dtype=torch.float32, device=images.device)
    bulk = geo.bulk and images.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    build.launch(_lib().st_inline_read_bwd, images.device, images, g, ay,
                 cy, ax, cx, d_img, *d_s, b, cs, ws, geo.cluster, geo.rows,
                 geo.out_rows, geo.threads, geo.smem_bytes, int(bulk))
    LAUNCHES["inline_attention_read_bwd"] += 1
    return (d_img, *d_s)


def write_accumulate_fwd(canvas, windows, ay, cy, ax, cx, coeff):
    """``canvas + coeff * (Wy @ windows @ Wx^T)`` [B, cs, cs] as a new
    tensor: the write kernel on CUDA tensors, its plain version on CPU
    tensors."""
    b, cs, ws = canvas.shape[0], canvas.shape[-1], windows.shape[-1]
    if canvas.device.type == "cpu":
        return write_accumulate_fwd_plain(canvas, windows, ay, cy, ax, cx,
                                          coeff)
    geo = fwd_geometry(b, ws, cs, "inline_write_accumulate")
    canvas, windows, ay, cy, ax, cx, coeff = build.contiguous(
        canvas, windows, ay, cy, ax, cx, coeff)
    out = torch.empty_like(canvas)
    build.launch(_lib().st_inline_write, canvas.device, canvas, windows, ay,
                 cy, ax, cx, coeff, out, b, cs, ws,
                 *_fwd_launch_args(geo, windows, canvas, out))
    LAUNCHES["inline_write_accumulate"] += 1
    return out


def write_accumulate_bwd(windows, g, ay, cy, ax, cx, coeff):
    """(d_windows, d_ay, d_cy, d_ax, d_cx, d_coeff) of the write: the
    backward kernel on CUDA tensors, ``write_accumulate_bwd_plain`` on CPU
    tensors."""
    b, ws, cs = windows.shape[0], windows.shape[-1], g.shape[-1]
    build.check("g", g, (b, cs, cs), windows.device)
    if windows.device.type == "cpu":
        return write_accumulate_bwd_plain(windows, g, ay, cy, ax, cx, coeff)
    geo = write_bwd_geometry(cs, ws)
    windows, g, ay, cy, ax, cx, coeff = build.contiguous(
        windows, g, ay, cy, ax, cx, coeff)
    d_win = torch.empty_like(windows)
    d_s = torch.empty((5, b), dtype=torch.float32, device=windows.device)
    bulk = geo.bulk and windows.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    build.launch(_lib().st_inline_write_bwd, windows.device, windows, g,
                 ay, cy, ax, cx, coeff, d_win, *d_s, b, cs, ws, geo.threads,
                 geo.smem_bytes, int(bulk))
    LAUNCHES["inline_write_accumulate_bwd"] += 1
    return (d_win, *d_s)


class _ReadCore(torch.autograd.Function):
    """Read with the (a, c) scalars of each axis as inputs; counterpart of
    ``_read_core``. Under ``torch.func.vmap`` the replicas fold into the
    image axis and each kernel launches once (``build.fold_replicas``)."""

    @staticmethod
    def forward(images, ay, cy, ax, cx, ws: int):
        return attention_read_fwd(images, ay, cy, ax, cx, ws)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])

    @staticmethod
    def backward(ctx, g):
        return (*attention_read_bwd(ctx.saved_tensors[0], g,
                                    *ctx.saved_tensors[1:]), None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return build.fold_replicas(_ReadCore, info, in_dims, *args)


class _WriteCore(torch.autograd.Function):
    """Write-accumulate with the (a, c) scalars of each axis and ``coeff`` as
    inputs; counterpart of ``_write_core``. The canvas's cotangent is g.
    Folds the replicas of a vmap as ``_ReadCore`` does."""

    @staticmethod
    def forward(canvas, windows, ay, cy, ax, cx, coeff):
        return write_accumulate_fwd(canvas, windows, ay, cy, ax, cx, coeff)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        return (g, *write_accumulate_bwd(ctx.saved_tensors[0], g,
                                         *ctx.saved_tensors[1:]))

    @staticmethod
    def vmap(info, in_dims, *args):
        return build.fold_replicas(_WriteCore, info, in_dims, *args)


# -------------------- wrappers ----------------------------------------------

def inline_attention_read(images: torch.Tensor, s: torch.Tensor,
                          x: torch.Tensor, y: torch.Tensor,
                          window_size: int) -> torch.Tensor:
    """Canvas -> window under theta [[s,0,x],[0,s,y]]: [B, cs, cs] images ->
    [B, ws, ws] windows, differentiable in every input."""
    b, cs = images.shape[0], images.shape[-1]
    ws = window_size
    if b < 1 or cs < 2 or ws < 2:
        raise ValueError(f"read: needs B >= 1 and sizes >= 2, got B={b}, "
                         f"cs={cs}, ws={ws}")
    dev = images.device
    build.check("images", images, (b, cs, cs), dev)
    build.check_scalars(dev, b, s=s, x=x, y=y)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"read: no kernel for device {dev}")
    # theta [[s, 0, x], [0, s, y]]: rows (y axis) use (s, y), columns (s, x)
    return _ReadCore.apply(images, s, y, s, x, ws)


def inline_write_accumulate(canvas_flat: torch.Tensor, windows: torch.Tensor,
                            s: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            coeff: torch.Tensor,
                            canvas_size: int) -> torch.Tensor:
    """``canvas + coeff * attention_write(windows, s, x, y)``: [B, cs*cs]
    canvas and [B, ws*ws] (or [B, ws, ws]) windows -> a new [B, cs*cs]
    canvas, differentiable in every input. The input canvas is left
    unchanged."""
    b, cs, ws = build.check_write(canvas_flat, windows, canvas_size, s=s,
                                  x=x, y=y, coeff=coeff)
    # window -> canvas theta [[1/s, 0, -x/s], [0, 1/s, -y/s]]
    inv_s = 1.0 / s
    out = _WriteCore.apply(canvas_flat.reshape(b, cs, cs),
                           windows.reshape(b, ws, ws), inv_s, -y * inv_s,
                           inv_s, -x * inv_s, coeff)
    return out.reshape(b, cs * cs)
