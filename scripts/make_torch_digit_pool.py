#!/usr/bin/env python3
"""Make the port's committed digit pool,
air_tpu_torch/assets/synthetic_mnist_60000_seed0.npz.

    python scripts/make_torch_digit_pool.py [--n 60000] [--seed 0] [--out PATH]

Renders ``synthesize_mnist(n, seed)`` (the port's copy of the JAX package's
renderer; needs PIL and the DejaVu fonts, so it runs where those are
installed, not on a machine without them) and stores it losslessly: the
uint8 ``k`` [n, 784], the float32 intensity ``u`` [n], the labels, and the
sha256 of the float32 images. It checks that ``decode_pool(k, u)`` gives
those images bit for bit before it writes.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from air_tpu_torch.data.mnist import (POOL, decode_pool,  # noqa: E402
                                      images_sha256, synthesize_mnist)


def make_pool(n: int, seed: int):
    """(arrays to store, the float32 images) of ``synthesize_mnist(n,
    seed)``; raises if decoding the arrays does not give the images."""
    images, labels, k, u = synthesize_mnist(n, seed, encoded=True)
    if not np.array_equal(decode_pool(k, u).view(np.uint32),
                          images.view(np.uint32)):
        raise AssertionError("decode_pool(k, u) differs from the images")
    return {"k": k, "u": u, "labels": labels,
            "sha256": np.asarray(images_sha256(images))}, images


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=60000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=POOL)
    args = parser.parse_args()
    t = time.perf_counter()
    arrays, _ = make_pool(args.n, args.seed)
    np.savez_compressed(args.out, **arrays)
    print(f"{args.out}: {args.n} digits, seed {args.seed}, "
          f"{os.path.getsize(args.out)} bytes, sha256 {arrays['sha256']}, "
          f"{time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
