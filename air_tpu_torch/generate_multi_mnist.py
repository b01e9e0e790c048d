"""Multi-MNIST dataset generator of the port:

    python -m air_tpu_torch.generate_multi_mnist --source sklearn \\
        --digit-slice :1400 --out-folder real_digits_data

Flag for flag the JAX package's ``scripts/generate_multi_mnist.py``, and
the same AIRREC records byte for byte for the same flags. Digits come from
``--mnist-folder`` (idx or npz) when present, else the committed digit
pool (``--source auto``), or from the 1,797 real handwritten UCI digits
(``--source sklearn``: the committed ``assets/uci_digits_8x8.npz``,
upsampled by ``--upsample``; no scikit-learn needed). ``--digit-slice a:b``
keeps a slice of the digits after a seed-0 shuffle, for pools disjoint
between a training set and a held-out one. ``--bg-path`` takes a PNG, read
without PIL (8-bit, non-interlaced: ``data/png.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--max-digits", type=int,
                        choices=list(range(7)), default=2)
    parser.add_argument("--max-in-common", type=int,
                        choices=list(range(7)), default=2)
    parser.add_argument("--images-per-digit", type=int, default=20000)
    parser.add_argument("--test-set-size", type=int, default=1000)
    parser.add_argument("--digit-gap", type=int, default=0)
    parser.add_argument("--canvas-margin", type=int, default=0)
    parser.add_argument("--bg-path", default="",
                        help="a PNG background (8-bit, non-interlaced)")
    parser.add_argument("--bg-kind", default="", help="procedural background: "
                        "noise|gradient|stripes|blobs|checker")
    parser.add_argument("--bg-max-intensity", type=float, default=1.0)
    parser.add_argument("--min-width-scale", type=float, default=1.0)
    parser.add_argument("--max-width-scale", type=float, default=1.0)
    parser.add_argument("--min-height-scale", type=float, default=1.0)
    parser.add_argument("--max-height-scale", type=float, default=1.0)
    parser.add_argument("--min-rotation-angle", type=float, default=0.0)
    parser.add_argument("--max-rotation-angle", type=float, default=0.0)
    parser.add_argument("--use-bounding-box-overlap", action="store_true")
    parser.add_argument("--canvas-size", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mnist-folder", default="mnist_data")
    parser.add_argument("--out-folder", default="multi_mnist_data")
    parser.add_argument("--source", default="auto",
                        choices=["auto", "sklearn"],
                        help="auto: real MNIST idx/npz from --mnist-folder "
                             "if present, else the committed digit pool. "
                             "sklearn: the 1797 real handwritten UCI "
                             "digits (upsampled 8x8 -> 28x28)")
    parser.add_argument("--upsample", default="bilinear",
                        choices=["bilinear", "bicubic"],
                        help="UCI 8x8 -> 28x28 glyph upsampling: bilinear "
                             "or bicubic (Catmull-Rom)")
    parser.add_argument("--digit-slice", default="",
                        help="a:b slice of the digit pool (after a "
                             "seed-0 shuffle), e.g. ':1400' / '1400:'")
    return parser


def digit_source(args) -> tuple:
    """(digits [N, 784], labels [N], description) as the flags pick them,
    the ``--digit-slice`` applied."""
    from air_tpu_torch.data.mnist import get_mnist, load_sklearn_digits

    if args.source == "sklearn":
        digits, labels = load_sklearn_digits(interp=args.upsample)
        source = f"sklearn-real-handwritten ({args.upsample})"
    else:
        digits, labels, source = get_mnist(args.mnist_folder)
    if args.digit_slice:
        a, b = args.digit_slice.split(":")
        perm = np.random.default_rng(0).permutation(len(digits))
        sel = perm[slice(int(a) if a else None, int(b) if b else None)]
        digits, labels = digits[sel], labels[sel]
    return digits, labels, source


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from air_tpu_torch.data import MultiMNISTConfig, generate_dataset

    digits, labels, source = digit_source(args)
    print(f"digit source: {source} ({len(digits)} digits)")
    os.makedirs(args.out_folder, exist_ok=True)
    cfg = MultiMNISTConfig(
        max_digits=args.max_digits, max_in_common=args.max_in_common,
        images_per_digit=args.images_per_digit,
        test_set_size=args.test_set_size,
        digit_gap=args.digit_gap, canvas_margin=args.canvas_margin,
        bg_path=args.bg_path, bg_kind=args.bg_kind,
        bg_max_intensity=args.bg_max_intensity,
        min_width_scale=args.min_width_scale,
        max_width_scale=args.max_width_scale,
        min_height_scale=args.min_height_scale,
        max_height_scale=args.max_height_scale,
        min_rotation_angle=args.min_rotation_angle,
        max_rotation_angle=args.max_rotation_angle,
        use_bounding_box_overlap=args.use_bounding_box_overlap,
        canvas_size=args.canvas_size, seed=args.seed)
    out = generate_dataset(
        digits, labels, cfg, out_dir=args.out_folder,
        progress=lambda d, n: print(f"{d}-digit images: {n} done"))
    print(f"{len(out['used_digit_ids'])} digits used for "
          f"0-{args.max_in_common} digit images")
    print(f"common: {len(out['common']['images'])} images, "
          f"test: {len(out['test']['images'])} images -> {args.out_folder}/")
    return out


if __name__ == "__main__":
    main()
