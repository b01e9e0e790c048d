"""Launch geometry of the two cluster backward kernels
(``csrc/st_cluster.cuh``): the streamed-weight write-accumulate backward
(``st_fused.bwd_geometry``) and the inline read backward
(``st_inline.read_bwd_geometry``).

Each image gets a cluster of ``cluster`` CTAs. CTA ``rank`` computes rows
``[rank * rows, (rank + 1) * rows)`` of the kernel's two intermediates (the
last group may have fewer) and rows ``[rank * out_rows, ...)`` of the output
that is split on its own (d_win, d_img). A thread's register tile is rows p
and p + rows / 2 by ``TILE_COLS`` columns q + c * ceil(width / TILE_COLS);
a range of the CTA's threads walks the tiles, products that do not depend
on each other side by side where they fit. The launchers refuse, with
cudaErrorInvalidValue, what ``geometry`` would not give; the CPU tests reach
the geometry here and mirror the kernels' thread-to-output map.
"""

from __future__ import annotations

import dataclasses

from air_tpu_torch.kernels import build

SMS = 132            # streaming multiprocessors of an H100 SXM
# CTAs per image at most: 2 measured fastest at B = 1 and 64, clusters of 4
# and 8 slower (PERF.md); the kernels take up to kMaxCluster = 8, the
# portable cluster size
MAX_CLUSTER = 2
MAX_THREADS = 256    # the kernels' __launch_bounds__ (kMaxThreads)
TILE_COLS = 4        # columns of a thread's register tile (kTileCols)
LANES = 256          # the reductions' lanes (kLanes)


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """One launch: ``cluster`` CTAs per image of ``threads`` threads and
    ``smem_bytes`` of shared memory each; ``rows`` rows of the intermediates
    and ``out_rows`` rows of the separately split output per CTA; ``bulk``
    when every staged range is a multiple of 16 bytes at a 16-byte offset (the
    wrapper also needs 16-byte aligned pointers for that path)."""
    cluster: int
    rows: int
    out_rows: int
    threads: int
    smem_bytes: int
    bulk: bool


def round4(n: int) -> int:
    return -(-n // 4) * 4


def split_rows(n: int, parts: int) -> int:
    """Rows per group, even (a tile's two rows), so that ``parts`` groups
    cover n rows."""
    return 2 * -(-(-(-n // parts)) // 2)


def tiles(rows: int, width: int) -> int:
    """Register tiles of a group of ``rows`` rows of ``width`` columns."""
    return rows // 2 * -(-width // TILE_COLS)


def geometry(batch: int, n: int, n_out: int, phases, smem_floats,
             sizes: tuple, name: str) -> ClusterGeometry:
    """The geometry of a launch whose intermediates have n rows and whose
    separately split output has n_out rows. The cluster is the largest power
    of two up to MAX_CLUSTER that keeps batch * cluster within SMS (at most
    one CTA per SM: 2 up to B = 66, 1 from B = 67 on). Rows are split in
    even groups, so the last CTAs of a small image may get no row of one
    product (they skip it). ``phases(rows, out_rows)`` lists the kernel's
    phases, each the work items of the products it runs side by side;
    threads: enough for the widest phase side by side, within MAX_THREADS
    (a phase that does not fit runs its products one after the other, each
    walking its items in a loop). ``smem_floats(rows)`` is the kernel's
    layout; ``sizes`` the staged ranges in floats. Raises if a CTA does not
    fit the card's shared memory."""
    cluster = 1
    while cluster * 2 <= MAX_CLUSTER and batch * cluster * 2 <= SMS:
        cluster *= 2
    rows, out_rows = split_rows(n, cluster), split_rows(n_out, cluster)
    most = max(sum(32 * -(-c // 32) for c in phase)
               for phase in phases(rows, out_rows))
    threads = min(MAX_THREADS, most)
    floats = smem_floats(rows)
    build.check_smem(name, floats)
    return ClusterGeometry(cluster, rows, out_rows, threads, 4 * floats,
                           all(s % 4 == 0 for s in sizes))
