#!/usr/bin/env python3
"""Device time of the streamed-weight kernels under launch geometries that
aim at different numbers of blocks.

    python3 scripts/sweep_st_geometry.py      # from the repository root

For the resample of kernels/st_pallas.py in both directions (read [B, 50, 50]
-> [B, 28, 28], write [B, 28, 28] -> [B, 50, 50]) and the write-accumulate
forward of kernels/st_fused.py, at B = 1, 64, 256 and 1024, and with
st_pallas.FILL_BLOCKS at 132, 264 and 528 (one, two and four blocks per SM
of an H100 SXM; the wrappers use 132): prints the geometry each target gives
(row groups, rows per group, threads, blocks) and the device ms per launch
(chip_smoke.device_ms: CUDA graphs of back-to-back launches, timed with
CUDA events), beside the library chain with the weights prebuilt. Every
launch is first held against the plain version (max abs diff 1e-5). Prints
the card's name and power limit first. Needs a card; writes nothing.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from air_tpu_torch.kernels import st_fused, st_pallas  # noqa: E402

BATCHES = (1, 64, 256, 1024)
FILLS = (132, 264, 528)
CS, WS = smoke.CS, smoke.WS


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(smoke.card(), flush=True)
    default = st_pallas.FILL_BLOCKS
    for b in BATCHES:
        d = smoke.kernel_inputs(b, seed=5000 + b)
        e = smoke.core_inputs(d, seed=6000 + b)
        (wy_r, wx_r), (wy_w, wx_w) = e["w_read"], e["w_write"]
        co_wy_w = wy_w * d["coeff"][:, None, None]
        wx_r_t, wx_w_t = wx_r.transpose(1, 2), wx_w.transpose(1, 2)
        cases = (
            ("pallas_attention_read", (WS, CS),
             lambda: torch.bmm(torch.bmm(wy_r, d["img"]), wx_r_t)),
            ("pallas_attention_write", (CS, WS),
             lambda: torch.bmm(torch.bmm(wy_w, d["win"]), wx_w_t)),
            ("fused_write_accumulate", (CS, WS),
             lambda: torch.baddbmm(smoke.canvas3(d),
                                   torch.bmm(co_wy_w, d["win"]), wx_w_t)))
        for name, (oh, ih), lib_fn in cases:
            fn, plain_fn, _ = smoke.KERNELS[name]
            want = plain_fn(d, e)
            parts = [f"{name} B={b}: library_ms="
                     f"{smoke.device_ms(lib_fn):.5f}"]
            for fill in FILLS:
                st_pallas.FILL_BLOCKS = fill
                try:
                    geo = (st_fused.geometry(b, CS, WS)
                           if name == "fused_write_accumulate"
                           else st_pallas.geometry(b, oh, oh, ih, ih))
                    err = float((fn(d, e) - want).abs().max())
                    ms = smoke.device_ms(lambda: fn(d, e))
                finally:
                    st_pallas.FILL_BLOCKS = default
                if not err <= smoke.KERNEL_TOL:
                    sys.exit(f"{name} B={b} fill {fill}: max abs diff {err}")
                parts.append(
                    f"fill {fill} (groups {geo.groups}, rows {geo.rows}, "
                    f"threads {geo.threads}, blocks {b * geo.groups}): "
                    f"ms={ms:.5f}")
            print("; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
