#!/usr/bin/env python3
"""Device time of the redesigned ST kernels under other launch geometries.

    python3 scripts/sweep_st_geometry.py      # from the repository root

At B = 1, 64, 256 and 1024, each beside its library chain
(chip_smoke.Library), the device ms per launch (chip_smoke.device_ms: CUDA
graphs of back-to-back launches, timed with CUDA events) of:

- the resample of kernels/st_pallas.py in both directions (read [B, 50, 50]
  -> [B, 28, 28], write [B, 28, 28] -> [B, 50, 50]) and the
  write-accumulate forward of kernels/st_fused.py, with st_pallas.FILL_BLOCKS
  at 132, 264 and 528 (one, two and four blocks per SM of an H100 SXM; the
  wrappers use 132);
- the write-accumulate backward of kernels/st_fused.py and the inline read
  backward of kernels/st_inline.py, with clusters of 1, 2, 4 and 8 CTAs per
  image (cluster.MAX_CLUSTER, with no limit from the SM count; the wrappers
  take the largest power of two that keeps one CTA per SM);
- the inline read and write forward of kernels/st_inline.py, with
  st_inline.FILL_BLOCKS at 132, 264, 528, 1056 and 4224 (1 to 32 blocks per
  SM; the band size follows), each with the input read through the
  read-only cache and staged in shared memory (st_inline.STAGE_ITEMS set so
  that no launch or every launch stages; the wrappers stage from 4 items
  per thread).

Prints the geometry each setting gives. Every launch is first held against
the plain version (max abs diff 1e-5 on the matrix outputs, 1e-4 x max(1,
|plain|) on the scalar ones). Prints the card's name and power limit first.
Needs a card; writes nothing.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from air_tpu_torch.kernels import (cluster, st_fused, st_inline,  # noqa: E402
                                   st_pallas)

BATCHES = (1, 64, 256, 1024)
FILLS = (132, 264, 528)
CLUSTERS = (1, 2, 4, 8)
FWD_FILLS = (132, 264, 528, 1056, 4224)
CS, WS = smoke.CS, smoke.WS
ROW_SPLIT = {
    "pallas_attention_read": lambda b: st_pallas.geometry(b, WS, WS, CS, CS),
    "pallas_attention_write": lambda b: st_pallas.geometry(b, CS, CS, WS, WS),
    "fused_write_accumulate": lambda b: st_fused.geometry(b, CS, WS),
}
TWO_TAP = {
    "inline_attention_read": lambda b: st_inline.fwd_geometry(b, CS, WS, ""),
    "inline_write_accumulate":
        lambda b: st_inline.fwd_geometry(b, WS, CS, ""),
}
CLUSTERED = {
    "fused_write_accumulate_bwd": lambda b: st_fused.bwd_geometry(b, CS, WS),
    "inline_attention_read_bwd":
        lambda b: st_inline.read_bwd_geometry(b, CS, WS),
}


def timed(name: str, d: dict, e: dict) -> float:
    """Device ms of kernel ``name`` after holding it against its plain
    version; exits on a disagreement."""
    fn, plain_fn, n_mat = smoke.KERNELS[name]
    mat, scal = smoke.errors(fn(d, e), plain_fn(d, e), n_mat)
    if not (mat <= smoke.KERNEL_TOL and scal <= smoke.SCALAR_TOL):
        sys.exit(f"{name}: matrix max abs diff {mat}, scalar {scal}")
    return smoke.device_ms(lambda: fn(d, e))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(smoke.card(), flush=True)
    for b in BATCHES:
        d = smoke.kernel_inputs(b, seed=5000 + b)
        e = smoke.core_inputs(d, seed=6000 + b)
        lib = smoke.Library(d, e)
        for name, geometry in ROW_SPLIT.items():
            parts = [f"{name} B={b}: library_ms={lib.ms(name):.5f}"]
            for fill in FILLS:
                default, st_pallas.FILL_BLOCKS = st_pallas.FILL_BLOCKS, fill
                try:
                    geo = geometry(b)
                    ms = timed(name, d, e)
                finally:
                    st_pallas.FILL_BLOCKS = default
                parts.append(
                    f"fill {fill} (groups {geo.groups}, rows {geo.rows}, "
                    f"threads {geo.threads}, blocks {b * geo.groups}): "
                    f"ms={ms:.5f}")
            print("; ".join(parts), flush=True)
        for name, geometry in TWO_TAP.items():
            geo = geometry(b)
            parts = [f"{name} B={b}: library_ms={lib.ms(name):.5f} "
                     f"(default fill {st_inline.FILL_BLOCKS}, stage "
                     f"{int(geo.stage)})"]
            for fill in FWD_FILLS:
                for stage in (False, True):
                    default = st_inline.FILL_BLOCKS, st_inline.STAGE_ITEMS
                    st_inline.FILL_BLOCKS = fill
                    st_inline.STAGE_ITEMS = 0 if stage else 1 << 30
                    try:
                        geo = geometry(b)
                        ms = timed(name, d, e)
                    finally:
                        st_inline.FILL_BLOCKS, st_inline.STAGE_ITEMS = default
                    parts.append(
                        f"fill {fill} stage {int(stage)} (bands {geo.bands}, "
                        f"rows {geo.rows}, threads {geo.threads}, blocks "
                        f"{b * geo.bands}): ms={ms:.5f}")
            print("; ".join(parts), flush=True)
        for name, geometry in CLUSTERED.items():
            parts = [f"{name} B={b}: library_ms={lib.ms(name):.5f} "
                     f"(default cluster {geometry(b).cluster})"]
            for size in CLUSTERS:
                sms, most = cluster.SMS, cluster.MAX_CLUSTER
                cluster.SMS, cluster.MAX_CLUSTER = 1 << 30, size
                try:
                    geo = geometry(b)
                    ms = timed(name, d, e)
                finally:
                    cluster.SMS, cluster.MAX_CLUSTER = sms, most
                parts.append(
                    f"cluster {size} (rows {geo.rows}, out_rows "
                    f"{geo.out_rows}, threads {geo.threads}, CTAs "
                    f"{b * geo.cluster}): ms={ms:.5f}")
            print("; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
