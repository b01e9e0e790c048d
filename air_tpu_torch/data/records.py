"""AIRREC record files — the framework's dataset container.

The port's own copy of ``air_tpu/data/records.py``, byte layout and all:
files written by either package are read by the other.

Replaces the reference's TFRecord files (reference multi_mnist.py:186-212,
228-251) with a flat, mmap-able binary layout that both the numpy reader
and the native C++ loader (air_tpu_torch/runtime) consume zero-copy:

    magic    8 bytes  b"AIRREC01"
    n        int32    number of records
    canvas   int32    canvas side length
    max_d    int32    per-record metadata padding width
    images   n * canvas^2   float32
    digits   n               int32
    indices  n * max_d       int32   (-1 padded)
    positions n * 2 * max_d  int32   (-1 padded; x,y pairs)
    boxes    n * 2 * max_d   int32   (-1 padded; w,h pairs)
    labels   n * max_d       int32   (-1 padded)

The per-record fields mirror the reference's TFRecord features
(reference multi_mnist.py:199-208) exactly: image, digits, indices,
positions, boxes, labels.
"""

from __future__ import annotations

import os

import numpy as np

MAGIC = b"AIRREC01"


def _pad(rows, width, dtype=np.int32, fill=-1):
    out = np.full((len(rows), width), fill, dtype)
    for i, r in enumerate(rows):
        r = np.asarray(r, dtype).ravel()
        out[i, :len(r)] = r
    return out


def write_records(path: str, images, digits, indices=None, positions=None,
                  boxes=None, labels=None, max_digits: int | None = None):
    """Write one AIRREC file. ``images``: [N, canvas^2] or [N, canvas,
    canvas]; metadata lists may be ragged (per-record variable length)."""
    images = np.asarray(images, np.float32)
    n = len(images)
    images = images.reshape(n, -1)
    canvas = int(round(np.sqrt(images.shape[1])))
    digits = np.asarray(digits, np.int32)
    if max_digits is None:
        max_digits = int(digits.max()) if n else 0
    max_digits = max(max_digits, 1)

    indices = _pad(indices if indices is not None else [[]] * n, max_digits)
    positions = _pad(positions if positions is not None else [[]] * n,
                     2 * max_digits)
    boxes = _pad(boxes if boxes is not None else [[]] * n, 2 * max_digits)
    labels = _pad(labels if labels is not None else [[]] * n, max_digits)

    if not path.endswith(".airrec"):
        path = path + ".airrec"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        np.array([n, canvas, max_digits], np.int32).tofile(f)
        images.tofile(f)
        digits.tofile(f)
        indices.tofile(f)
        positions.tofile(f)
        boxes.tofile(f)
        labels.tofile(f)
    return path


def read_records(path: str, mmap: bool = True):
    """Read an AIRREC file. Returns a dict of arrays:
    images [N, canvas^2] float32, digits [N] int32, and -1-padded
    indices/positions/boxes/labels int32 arrays."""
    if not path.endswith(".airrec") and not os.path.exists(path):
        path = path + ".airrec"
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not an AIRREC01 file")
        n, canvas, max_d = np.fromfile(f, np.int32, 3)
        n, canvas, max_d = int(n), int(canvas), int(max_d)
        header = f.tell()

    counts = {
        "images": (np.float32, n * canvas * canvas, (n, canvas * canvas)),
        "digits": (np.int32, n, (n,)),
        "indices": (np.int32, n * max_d, (n, max_d)),
        "positions": (np.int32, n * 2 * max_d, (n, 2 * max_d)),
        "boxes": (np.int32, n * 2 * max_d, (n, 2 * max_d)),
        "labels": (np.int32, n * max_d, (n, max_d)),
    }
    out = {"canvas_size": canvas, "max_digits": max_d}
    offset = header
    for name, (dtype, count, shape) in counts.items():
        nbytes = count * np.dtype(dtype).itemsize
        if mmap:
            arr = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                            shape=shape)
        else:
            with open(path, "rb") as f:
                f.seek(offset)
                arr = np.fromfile(f, dtype, count).reshape(shape)
        out[name] = arr
        offset += nbytes
    return out


def read_test_data(path: str, shift_zero_digits_images: bool = False):
    """Reference-shaped test reader (reference multi_mnist.py:254-296):
    returns (images, digits, indices, positions, boxes, labels) with the
    ragged per-record metadata trimmed to the true digit count, and the
    optional move-one-empty-image-first reshuffle used by training.py:154-156.
    """
    r = read_records(path)
    images = np.array(r["images"])
    digits = np.array(r["digits"])
    indices = [r["indices"][i, :digits[i]].copy() for i in range(len(digits))]
    positions = [r["positions"][i, :digits[i] * 2].copy()
                 for i in range(len(digits))]
    boxes = [r["boxes"][i, :digits[i] * 2].copy() for i in range(len(digits))]
    labels = [r["labels"][i, :digits[i]].copy() for i in range(len(digits))]

    if shift_zero_digits_images:
        empty = [i for i in range(len(digits)) if digits[i] == 0]
        non_empty = [i for i in range(len(digits)) if digits[i] > 0]
        order = [empty[0]] + non_empty + empty[1:]
        images = images[order]
        digits = digits[order]

    return images, digits, indices, positions, boxes, labels
