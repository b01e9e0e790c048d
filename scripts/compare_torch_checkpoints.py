#!/usr/bin/env python3
"""Compare two checkpoints of the port array by array, bit for bit.

    python scripts/compare_torch_checkpoints.py A.npz B.npz

Prints each file's step, its number of arrays and a sha256 over its
arrays (in key order), then whether every array (params, optimizer leaves,
step) holds the same bytes. Exits 1 when they differ. The sidecars are not
compared: they also hold eval history, which depends on where a run began.
"""

import hashlib
import sys

import numpy as np


def arrays(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in sorted(z.files)}


def digest(arrs: dict) -> str:
    h = hashlib.sha256()
    for k, v in arrs.items():
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    a, b = (arrays(p) for p in sys.argv[1:3])
    for path, arrs in zip(sys.argv[1:3], (a, b)):
        print(f"{path}: step {int(arrs['step'])}, {len(arrs)} arrays, "
              f"sha256 {digest(arrs)}")
    differ = sorted(k for k in a.keys() | b.keys()
                    if k not in a or k not in b
                    or a[k].dtype != b[k].dtype
                    or a[k].tobytes() != b[k].tobytes())
    print(f"bit-equal: {not differ}" + (f" (differ: {differ[:8]})"
                                         if differ else ""))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
