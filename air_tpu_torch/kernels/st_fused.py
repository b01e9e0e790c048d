"""The streamed-weight attention write fused with the masked canvas
accumulate, forward and backward in hand-written CUDA kernels
(``csrc/st_fused.cu``).

Counterpart of ``air_tpu/kernels/st_fused.py``: ``fused_write_accumulate``
(TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``),

    canvas_out = canvas + coeff * (Wy @ windows @ Wx^T),

with ``coeff = alive * z_pres`` and the dense weight matrices ``Wy``, ``Wx``
[B, cs, ws] of the window -> canvas map built outside the kernels by the
differentiable ``air_tpu_torch.ops.transformer._axis_weight_matrix``. One
``torch.autograd.Function`` over ``(canvas, windows, Wy, Wx, coeff)`` runs
the forward kernel in ``forward`` and the backward kernel in ``backward``,
which returns ``(g, d_windows, d_Wy, d_Wx, d_coeff)`` as ``_wmac_bwd`` does;
the gradients of ``(s, x, y)`` flow on through the weights' construction.

On CUDA tensors the Function launches the kernels or raises; on CPU tensors
it computes the plain versions ``wmac_fwd_plain`` and ``wmac_bwd_plain``
(the backward as explicit products, not autograd through the plain
forward). Each launch adds one to ``LAUNCHES["fused_write_accumulate"]`` or
``LAUNCHES["fused_write_accumulate_bwd"]``, and nothing else does.

``geometry`` (the forward's row split, ``st_pallas.geometry``) and
``bwd_geometry`` (the backward's clusters, ``cluster.geometry``) compute how
a launch splits its work; the launchers check what they are given, and the
CPU tests reach both here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from air_tpu_torch.kernels import build, cluster, st_pallas
from air_tpu_torch.ops.transformer import _axis_weight_matrix

LAUNCHES = {"fused_write_accumulate": 0, "fused_write_accumulate_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("st_fused").lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    for fn, n_ptr, n_int in ((lib.st_wmac_fwd, 6, 8), (lib.st_wmac_bwd, 9, 9)):
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        fn.restype = i32
    return lib


def geometry(b: int, cs: int, ws: int) -> st_pallas.Geometry:
    """Launch geometry of the forward kernel: the streamed-weight write
    [B, ws, ws] -> [B, cs, cs] with the canvas rows (``st_pallas.geometry``
    with ``canvas``)."""
    return st_pallas.geometry(b, cs, cs, ws, ws, canvas=True,
                              name="fused_write_accumulate")


def _bwd_smem_floats(cs: int, ws: int) -> int:
    """Floats of one backward CTA's shared memory, as st_fused.cu's
    BwdLayout: g, win, Wy, Wx, win^T at an odd row stride, gwx, tmp, and
    d_coeff's lanes and warp sums; each region on 16 bytes."""
    r4 = cluster.round4
    return (r4(cs * cs) + r4(ws * ws) + 4 * r4(cs * ws) + r4(ws * (ws | 1))
            + cluster.LANES + cluster.LANES // 32)


def bwd_geometry(b: int, cs: int, ws: int) -> cluster.ClusterGeometry:
    """Launch geometry of the backward kernel (``cluster.geometry``): the
    clusters split the cs rows of gwx and tmp (and of d_Wy and d_Wx), and
    the ws rows of d_win."""
    return cluster.geometry(
        b, cs, ws, functools.partial(_bwd_phases, ws=ws),
        lambda rows: _bwd_smem_floats(cs, ws), (cs * cs, ws * ws, cs * ws),
        "fused_write_accumulate_bwd")


def _bwd_phases(rows: int, out_rows: int, ws: int) -> list:
    """The backward's products side by side, as register tiles: gwx and tmp
    (``rows`` rows each), then d_Wy, d_Wx (``rows``) and d_win
    (``out_rows``), all ws wide."""
    t, t_out = cluster.tiles(rows, ws), cluster.tiles(out_rows, ws)
    return [(t, t), (t, t, t_out)]


def _check_operands(windows, wy, wx, coeff, cs_cs: torch.Tensor) -> tuple:
    """(b, cs, ws) of the operands; raises on what the kernels do not take.
    ``cs_cs`` is the canvas or its cotangent, [B, cs, cs]."""
    b, cs, ws = wy.shape
    dev = cs_cs.device
    build.check("canvas", cs_cs, (b, cs, cs), dev)
    build.check("windows", windows, (b, ws, ws), dev)
    build.check("Wy", wy, (b, cs, ws), dev)
    build.check("Wx", wx, (b, cs, ws), dev)
    build.check_scalars(dev, b, coeff=coeff)
    return b, cs, ws


# -------------------- plain versions ----------------------------------------

def wmac_fwd_plain(canvas, windows, wy, wx, coeff):
    """Plain PyTorch version of the forward kernel: ``canvas + coeff *
    (Wy @ windows @ Wx^T)`` on [B, cs, cs] canvases."""
    return canvas + coeff[:, None, None] * torch.bmm(
        torch.bmm(wy, windows), wx.transpose(1, 2))


def wmac_bwd_plain(windows, wy, wx, coeff, g):
    """Plain PyTorch version of the backward kernel: from the canvas
    cotangent g [B, cs, cs], (d_windows, d_Wy, d_Wx, d_coeff)."""
    c = coeff[:, None, None]
    gwx = torch.bmm(g, wx)                                    # [B, cs, ws]
    tmp = torch.bmm(wy, windows)                              # [B, cs, ws]
    d_wy = c * torch.bmm(gwx, windows.transpose(1, 2))
    d_win = c * torch.bmm(wy.transpose(1, 2), gwx)
    d_wx = c * torch.bmm(g.transpose(1, 2), tmp)
    d_coeff = (g * torch.bmm(tmp, wx.transpose(1, 2))).sum((1, 2))
    return d_win, d_wy, d_wx, d_coeff


# -------------------- kernels, or their plain versions on the CPU ------------

def wmac_fwd(canvas, windows, wy, wx, coeff) -> torch.Tensor:
    """``canvas + coeff * (Wy @ windows @ Wx^T)`` [B, cs, cs] as a new
    tensor: the forward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    b, cs, ws = _check_operands(windows, wy, wx, coeff, canvas)
    if canvas.device.type == "cpu":
        return wmac_fwd_plain(canvas, windows, wy, wx, coeff)
    geo = geometry(b, cs, ws)
    wy, windows, wx, coeff, canvas = build.contiguous(wy, windows, wx, coeff,
                                                      canvas)
    out = torch.empty_like(canvas)
    build.launch(_lib().st_wmac_fwd, canvas.device, wy, windows, wx, coeff,
                 canvas, out, b, cs, ws, geo.groups, geo.rows, geo.threads,
                 geo.smem_bytes,
                 st_pallas.bulk_ok(geo, wy, windows, wx, canvas, out))
    LAUNCHES["fused_write_accumulate"] += 1
    return out


def wmac_bwd(windows, wy, wx, coeff, g):
    """(d_windows, d_Wy, d_Wx, d_coeff) from the canvas cotangent g: the
    backward kernel on CUDA tensors, ``wmac_bwd_plain`` on CPU tensors."""
    b, cs, ws = _check_operands(windows, wy, wx, coeff, g)
    if g.device.type == "cpu":
        return wmac_bwd_plain(windows, wy, wx, coeff, g)
    geo = bwd_geometry(b, cs, ws)
    wy, windows, wx, coeff, g = build.contiguous(wy, windows, wx, coeff, g)
    d_wy, d_wx = torch.empty_like(wy), torch.empty_like(wx)
    d_win = torch.empty_like(windows)
    d_coeff = torch.empty_like(coeff)
    bulk = geo.bulk and all(t.data_ptr() % 16 == 0
                            for t in (wy, windows, wx, g))
    build.launch(_lib().st_wmac_bwd, g.device, wy, windows, wx, coeff, g,
                 d_wy, d_win, d_wx, d_coeff, b, cs, ws, geo.cluster, geo.rows,
                 geo.out_rows, geo.threads, geo.smem_bytes, int(bulk))
    LAUNCHES["fused_write_accumulate_bwd"] += 1
    return d_win, d_wy, d_wx, d_coeff


class _WmacCore(torch.autograd.Function):
    """``canvas + coeff * (Wy @ windows @ Wx^T)`` with the weight matrices
    as inputs; the counterpart of ``_wmac_core``. The canvas's cotangent is
    g."""

    @staticmethod
    def forward(ctx, canvas, windows, wy, wx, coeff):
        ctx.save_for_backward(windows, wy, wx, coeff)
        return wmac_fwd(canvas, windows, wy, wx, coeff)

    @staticmethod
    def backward(ctx, g):
        return (g, *wmac_bwd(*ctx.saved_tensors, g))


# -------------------- wrapper -----------------------------------------------

def fused_write_accumulate(canvas_flat: torch.Tensor, windows: torch.Tensor,
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
    wy = _axis_weight_matrix(inv_s, -y * inv_s, cs, ws)       # [B, cs, ws]
    wx = _axis_weight_matrix(inv_s, -x * inv_s, cs, ws)
    out = _WmacCore.apply(canvas_flat.reshape(b, cs, cs),
                          windows.reshape(b, ws, ws), wy, wx, coeff)
    return out.reshape(b, cs * cs)
