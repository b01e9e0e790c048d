#!/usr/bin/env python3
"""Make the port's committed real-handwriting digits,
air_tpu_torch/assets/uci_digits_8x8.npz.

    python scripts/make_torch_uci_digits.py [--out PATH]

Reads the 1,797 8x8 glyphs of the UCI Optical Recognition of Handwritten
Digits test set as scikit-learn bundles them (``sklearn.datasets.
load_digits``: no download; needs scikit-learn, so it runs where that is
installed) and stores them losslessly: the glyphs as uint8 0-16
[1797, 8, 8], the labels, and the sha256 of the decoded float32 glyphs
(``glyphs / 16``) that ``air_tpu_torch.data.mnist.load_uci_glyphs`` checks.
It checks that the uint8 glyphs give scikit-learn's values bit for bit
before it writes.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from air_tpu_torch.data.mnist import (UCI_DIGITS,  # noqa: E402
                                      decode_uci, images_sha256)


def make_digits() -> dict:
    """The arrays to store; raises unless they decode to scikit-learn's
    glyphs bit for bit."""
    from sklearn.datasets import load_digits
    d = load_digits()
    glyphs = d.images.astype(np.uint8)
    if not np.array_equal(glyphs.astype(d.images.dtype), d.images):
        raise AssertionError("load_digits() holds values other than 0-16")
    decoded = decode_uci(glyphs)
    if not np.array_equal(decoded, d.images.astype(np.float32) / 16.0):
        raise AssertionError("decode_uci differs from load_digits() / 16")
    return {"glyphs": glyphs, "labels": d.target.astype(np.int32),
            "sha256": np.asarray(images_sha256(decoded))}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=UCI_DIGITS)
    args = parser.parse_args()
    arrays = make_digits()
    np.savez_compressed(args.out, **arrays)
    print(f"{args.out}: {len(arrays['labels'])} digits, "
          f"{os.path.getsize(args.out)} bytes, sha256 {arrays['sha256']}")


if __name__ == "__main__":
    main()
