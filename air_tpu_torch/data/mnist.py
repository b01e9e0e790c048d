"""MNIST digit sources, without a download and without PIL where it runs.

The port's counterpart of ``air_tpu/data/mnist.py``:

  1. ``load_mnist(dir)`` — reads the standard IDX ubyte files (gzipped or
     raw) or a cached ``mnist.npz`` if present on disk (a copy of the JAX
     package's reader).
  2. ``load_digit_pool()`` — the committed pool
     ``assets/synthetic_mnist_60000_seed0.npz``: the JAX package's
     ``synthesize_mnist(60000, seed=0)``, stored losslessly. Every pixel
     that function makes is ``clip((k / 255) * u * 1.4, 0, 1)`` in float32,
     with ``k`` a uint8 and ``u`` one float32 per image, so the asset keeps
     ``k`` [N, 784], ``u`` [N] and the labels, and decoding gives the
     original images bit for bit (checked against the sha256 stored with
     them).
  3. ``synthesize_mnist(n, seed)`` — a copy of the JAX package's renderer,
     which needs PIL and the DejaVu fonts; only
     ``scripts/make_torch_digit_pool.py`` calls it, to make the asset.
  4. ``load_sklearn_digits(target_ink_size, interp)`` — the 1,797 real
     handwritten 8x8 digits of the UCI Optical Recognition of Handwritten
     Digits test set, as scikit-learn bundles them, upsampled into the
     MNIST frame as the JAX package's ``load_sklearn_digits`` does, bit for
     bit. They are read from the committed ``assets/uci_digits_8x8.npz``
     (uint8 0-16 glyphs, labels, the sha256 of the decoded glyphs; made by
     ``scripts/make_torch_uci_digits.py``), so no scikit-learn is needed.

``get_mnist`` takes real MNIST when it is on disk, else the committed pool.
It never synthesizes, so it runs where PIL and the fonts are absent.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct

import numpy as np

IMAGE_SIZE = 28
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")
POOL = os.path.join(ASSETS, "synthetic_mnist_60000_seed0.npz")
UCI_DIGITS = os.path.join(ASSETS, "uci_digits_8x8.npz")

_FONT_PATHS = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf",
]


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(data_dir: str):
    """Load MNIST train split from ``data_dir``.

    Accepts either ``mnist.npz`` (keys: x_train [N,28,28] uint8, y_train [N])
    or the classic idx files ``train-images-idx3-ubyte[.gz]`` /
    ``train-labels-idx1-ubyte[.gz]``. Returns (images [N, 784] float32 in
    [0,1], labels [N] int32), matching the reference's
    ``dataset.train.images`` layout (flat, normalized).
    """
    npz = os.path.join(data_dir, "mnist.npz")
    if os.path.exists(npz):
        with np.load(npz) as d:
            images, labels = d["x_train"], d["y_train"]
    else:
        img_path = None
        lbl_path = None
        for suffix in ("", ".gz"):
            p = os.path.join(data_dir, "train-images-idx3-ubyte" + suffix)
            q = os.path.join(data_dir, "train-labels-idx1-ubyte" + suffix)
            if os.path.exists(p) and os.path.exists(q):
                img_path, lbl_path = p, q
                break
        if img_path is None:
            raise FileNotFoundError(
                f"no MNIST files (mnist.npz or idx ubyte) in {data_dir!r}")
        images = _read_idx(img_path)
        labels = _read_idx(lbl_path)
    images = images.reshape(len(images), -1).astype(np.float32) / 255.0
    return images, labels.astype(np.int32)


def images_sha256(images: np.ndarray) -> str:
    """sha256 of float32 images' bytes, C order."""
    return hashlib.sha256(
        np.ascontiguousarray(images, np.float32).tobytes()).hexdigest()


def decode_pool(k: np.ndarray, u: np.ndarray) -> np.ndarray:
    """uint8 ``k`` [N, 784] and float32 ``u`` [N] -> the float32 images,
    with ``synthesize_mnist``'s roundings: ``k / 255``, times ``u``, times
    1.4, clipped, each step in float32."""
    images = k.astype(np.float32) / 255.0
    images *= np.asarray(u, np.float32)[:, None]
    return np.clip(images * 1.4, 0.0, 1.0)


def load_digit_pool():
    """The committed digit pool, decoded: (images [N, 784] float32, labels
    [N] int32), checked against the sha256 stored in the asset."""
    with np.load(POOL) as z:
        k, u, labels = z["k"], z["u"], z["labels"]
        want = str(z["sha256"])
    images = decode_pool(k, u)
    if images_sha256(images) != want:
        raise ValueError(f"{POOL}: decoded images do not match their "
                         f"recorded sha256 {want}")
    return images, np.asarray(labels, np.int32)


def synthesize_mnist(n: int = 60000, seed: int = 0, encoded: bool = False):
    """Render n MNIST-like 28x28 digit images deterministically, offline.

    Per sample: random digit 0-9, random DejaVu font, random point size
    (18-26), small random rotation/shear/translation, random peak intensity
    (0.75-1.0), light blur. Returns (images [n, 784] float32, labels [n]);
    with ``encoded`` also the uint8 ``k`` [n, 784] and float32 ``u`` [n]
    that ``decode_pool`` turns back into the images.
    """
    from PIL import Image, ImageDraw, ImageFont, ImageFilter

    rng = np.random.default_rng(seed)
    fonts = [p for p in _FONT_PATHS if os.path.exists(p)]
    if not fonts:
        raise RuntimeError("no TTF fonts found for synthetic MNIST")
    # pre-load a grid of (font, size) variants; sizes/strokes chosen so the
    # ink statistics match MNIST (~150 ink px at ~0.75 mean intensity —
    # AIR's attention bootstrap is sensitive to ink mass)
    sizes = list(range(20, 29))
    loaded = {}
    for fp in fonts:
        for s in sizes:
            loaded[(fp, s)] = ImageFont.truetype(fp, s)

    images = np.zeros((n, IMAGE_SIZE * IMAGE_SIZE), np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    ks = np.zeros((n, IMAGE_SIZE * IMAGE_SIZE), np.uint8)
    us = np.zeros(n, np.float32)

    big = IMAGE_SIZE * 2
    for i in range(n):
        digit = int(labels[i])
        font = loaded[(fonts[rng.integers(len(fonts))],
                       sizes[rng.integers(len(sizes))])]
        img = Image.new("L", (big, big), 0)
        stroke = int(rng.integers(1, 3))
        ImageDraw.Draw(img).text((big // 3, big // 6), str(digit),
                                 fill=255, font=font,
                                 stroke_width=stroke, stroke_fill=255)
        # small random affine: rotation +- 12 deg, jitter
        angle = rng.uniform(-12, 12)
        img = img.rotate(angle, resample=Image.BILINEAR,
                         center=(big // 2, big // 2))
        img = img.filter(ImageFilter.GaussianBlur(rng.uniform(0.3, 0.8)))
        arr = np.asarray(img, np.float32) / 255.0
        # crop tightly around ink, then paste centered-with-jitter into 28x28
        ys, xs = np.nonzero(arr > 0.05)
        if len(ys) == 0:
            arr = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
        else:
            crop = arr[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            ch, cw = crop.shape
            scale = min((IMAGE_SIZE - 8) / max(ch, cw), 1.0)
            if scale < 1.0:
                im2 = Image.fromarray((crop * 255).astype(np.uint8))
                im2 = im2.resize((max(1, int(cw * scale)),
                                  max(1, int(ch * scale))),
                                 Image.BILINEAR)
                crop = np.asarray(im2, np.float32) / 255.0
                ch, cw = crop.shape
            canvas = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
            oy = (IMAGE_SIZE - ch) // 2 + int(rng.integers(-2, 3))
            ox = (IMAGE_SIZE - cw) // 2 + int(rng.integers(-2, 3))
            oy = np.clip(oy, 0, IMAGE_SIZE - ch)
            ox = np.clip(ox, 0, IMAGE_SIZE - cw)
            canvas[oy:oy + ch, ox:ox + cw] = crop
            arr = canvas
        # every pixel is k / 255 for a uint8 k here
        ks[i] = np.rint(arr.ravel() * 255.0).astype(np.uint8)
        u = rng.uniform(0.9, 1.0)
        us[i] = u
        arr *= u
        images[i] = np.clip(arr * 1.4, 0.0, 1.0).ravel()

    if encoded:
        return images, labels, ks, us
    return images, labels


def decode_uci(glyphs: np.ndarray) -> np.ndarray:
    """uint8 glyphs 0-16 -> float32 in [0, 1], as the JAX package divides
    scikit-learn's float64 values once cast to float32."""
    return glyphs.astype(np.float32) / 16.0


def load_uci_glyphs():
    """The committed UCI digits: (glyphs [1797, 8, 8] float32 in [0, 1],
    labels [1797] int32), checked against the sha256 stored in the
    asset."""
    with np.load(UCI_DIGITS) as z:
        glyphs, labels = z["glyphs"], z["labels"]
        want = str(z["sha256"])
    src = decode_uci(glyphs)
    if images_sha256(src) != want:
        raise ValueError(f"{UCI_DIGITS}: decoded glyphs do not match their "
                         f"recorded sha256 {want}")
    return src, np.asarray(labels, np.int32)


def _cubic_kernel(t: np.ndarray) -> np.ndarray:
    """Catmull-Rom cubic convolution weights (a=-0.5, the standard
    bicubic kernel) for |t| in [0, 2)."""
    a = -0.5
    t = np.abs(t)
    w = np.where(
        t <= 1.0,
        (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
        np.where(t < 2.0, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                 0.0))
    return w.astype(np.float32)


def _upsample_weights(k: int, src: int, interp: str) -> np.ndarray:
    """[k, src] separable upsampling matrix sampling source pixel centers
    (edge-clamped). interp: 'bilinear' (hat) or 'bicubic' (Catmull-Rom,
    rows renormalized where the clamp truncates the support)."""
    coords = (np.arange(k, dtype=np.float32) + 0.5) * (src / k) - 0.5
    coords = np.clip(coords, 0.0, src - 1.0)
    idx = np.arange(src, dtype=np.float32)
    t = coords[:, None] - idx[None, :]               # [k, src]
    if interp == "bilinear":
        w = np.maximum(0.0, 1.0 - np.abs(t)).astype(np.float32)
    elif interp == "bicubic":
        w = _cubic_kernel(t)
    else:
        raise ValueError(f"unknown interp {interp!r}")
    return w / w.sum(axis=1, keepdims=True)


def load_sklearn_digits(target_ink_size: int = 20,
                        interp: str = "bilinear"):
    """The 1797 real handwritten UCI digits (8x8, values 0-16, ~180 per
    class), each upsampled to ``target_ink_size``² and pasted centered in
    the MNIST 28x28 frame, as ``air_tpu/data/mnist.py``'s
    ``load_sklearn_digits`` makes them from scikit-learn, bit for bit.

    ``interp``: 'bilinear' (the default; the JAX package's round-4
    datasets, whose operation order it keeps) or 'bicubic' (Catmull-Rom).

    Returns (images [1797, 784] float32 in [0,1], labels [1797] int32).
    """
    src, labels = load_uci_glyphs()
    n = len(src)
    k = target_ink_size
    if interp == "bilinear":
        # bilinear 8x8 -> kxk sampled at pixel centers, rows then columns,
        # in the JAX package's order of operations
        coords = (np.arange(k, dtype=np.float32) + 0.5) * (8.0 / k) - 0.5
        coords = np.clip(coords, 0.0, 7.0)
        i0 = np.minimum(coords.astype(np.int32), 6)
        frac = coords - i0
        rows = (src[:, i0, :] * (1 - frac)[None, :, None]
                + src[:, i0 + 1, :] * frac[None, :, None])
        up = (rows[:, :, i0] * (1 - frac)[None, None, :]
              + rows[:, :, i0 + 1] * frac[None, None, :])
    else:
        W = _upsample_weights(k, 8, interp)          # [k, 8]
        up = np.einsum("ki,nij,lj->nkl", W, src, W)
        # cubic lobes overshoot at hard edges; stay in [0, 1] pre-scale
        up = np.clip(up, 0.0, 1.0)

    pad = (IMAGE_SIZE - k) // 2
    images = np.zeros((n, IMAGE_SIZE, IMAGE_SIZE), np.float32)
    images[:, pad:pad + k, pad:pad + k] = up
    # saturate stroke cores (synthesize_mnist's 1.4x clip): upsampling
    # spreads the 8x8 antialiasing to a mean ink of ~0.54 against MNIST's
    # ~0.78
    return np.clip(images.reshape(n, -1) * 1.4, 0.0, 1.0), labels


def get_mnist(data_dir: str = "mnist_data"):
    """Real MNIST from ``data_dir`` if present, else the committed pool.

    Returns (images [N,784] float32, labels [N] int32, source_str)."""
    try:
        images, labels = load_mnist(data_dir)
        return images, labels, "mnist"
    except (FileNotFoundError, OSError):
        images, labels = load_digit_pool()
        return images, labels, "synthetic"
