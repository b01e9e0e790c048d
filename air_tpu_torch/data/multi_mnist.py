"""Stratified multi-MNIST dataset generator.

The port's own copy of ``air_tpu/data/multi_mnist.py``: every draw from
the generator and every ``scipy.ndimage`` call in the same order, so the
same digit pool and seed give the JAX package's canvases, metadata and
positions bit for bit. ``read_image`` (a ``bg_path``) reads PNG only,
through the port's own decoder (``data/png.py``), so the backgrounds need
no PIL; the JAX package's reads any format PIL opens.

Re-implements the reference generator (reference multi_mnist.py:82-183,
299-414) with the same capabilities: for each digit count 0..max_digits,
``images_per_digit`` canvases of non-overlapping random digits, optional
per-digit rescale/rotation, optional background compositing, pixel- or
bbox-overlap placement with up to 100 attempts per digit and full-canvas
retry, a reshuffling digit-id stream over the 60k digit pool, and the
stratified common/test split.

Deliberate fixes vs. the reference (documented deviations):
  * ``generate_multi_image`` takes its digit count as an argument instead
    of reading a module-level global (reference multi_mnist.py:99 quirk).
  * The bounding-box overlap test implements the correct AABB intersection;
    the reference's version (multi_mnist.py:68-79) returns "overlap"
    whenever x-intervals merely intersect and has an inverted y test.
  * ``add_buffer`` (1-px-per-gap dilation, reference multi_mnist.py:45-58)
    is a vectorized maximum-filter instead of a quadruple python loop.

Output: AIRREC files (air_tpu_torch.data.records) instead of TFRecords.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from air_tpu_torch.data.png import read_png_grey

try:
    import scipy.ndimage as nd
except ImportError:  # pragma: no cover
    nd = None


def read_image(path: str, max_intensity: float = 1.0) -> np.ndarray:
    """Load a grayscale background normalized to [0, max_intensity]
    (reference multi_mnist.py:17-33). The JAX package opens any format PIL
    does; this reads PNG only, without PIL (``png.read_png_grey``: 8-bit,
    non-interlaced, grey as PIL's ``convert("L")`` gives it), and raises
    ``ValueError`` on anything else."""
    image = read_png_grey(path).astype(np.float32) / 255.0
    img_min, img_max = image.min(), image.max()
    if img_min != img_max:
        if img_min > 0.0:
            image = image - img_min
        if img_max > 0.0:
            image = image / image.max()
        if max_intensity < 1.0:
            image = image * max_intensity
    else:
        if img_max > max_intensity:
            image = np.ones_like(image) * max_intensity
    return image


def prepare_background(canvas_size: int, bg_path: str = "",
                       bg_kind: str = "", max_intensity: float = 1.0,
                       seed: int = 0):
    """The dataset's static background texture as a [canvas, canvas]
    array, or None: a PNG via :func:`read_image` (reference
    multi_mnist.py:319,334) or a procedural texture
    (air_tpu_torch.data.backgrounds), center-cropped / tiled to canvas size.
    Shared by the generator and the training-driver's on-device
    intensity-curriculum compositor so both see the SAME pixels."""
    if bg_path:
        bg = read_image(bg_path, max_intensity)
    elif bg_kind:
        from air_tpu_torch.data.backgrounds import generate_background
        bg = generate_background(bg_kind, canvas_size, seed, max_intensity)
    else:
        return None
    if bg.shape != (canvas_size, canvas_size):
        bh, bw = bg.shape
        if bh < canvas_size or bw < canvas_size:
            reps = (canvas_size // bh + 1, canvas_size // bw + 1)
            bg = np.tile(bg, reps)
        bg = bg[:canvas_size, :canvas_size]
    return bg


def crop_non_empty(image: np.ndarray) -> np.ndarray:
    """Tight crop to nonzero rows/cols (reference multi_mnist.py:36-42)."""
    cols = np.nonzero(image.sum(axis=0))[0]
    rows = np.nonzero(image.sum(axis=1))[0]
    return image[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]


def add_buffer(image: np.ndarray, buffer_width: int) -> np.ndarray:
    """Dilate the ink mask by ``buffer_width`` (chebyshev), marking the halo
    with 1.0 — gap enforcement for pixel-overlap placement
    (reference multi_mnist.py:45-58, vectorized)."""
    if buffer_width <= 0:
        return np.copy(image)
    if nd is not None:
        halo = nd.maximum_filter(
            (image > 0).astype(np.float32), size=2 * buffer_width + 1)
    else:  # pure-numpy fallback
        mask = (image > 0).astype(np.float32)
        halo = np.zeros_like(mask)
        h, w = mask.shape
        b = buffer_width
        for dy in range(-b, b + 1):
            for dx in range(-b, b + 1):
                ys = slice(max(0, dy), min(h, h + dy))
                yd = slice(max(0, -dy), min(h, h - dy))
                xs = slice(max(0, dx), min(w, w + dx))
                xd = slice(max(0, -dx), min(w, w - dx))
                halo[yd, xd] = np.maximum(halo[yd, xd], mask[ys, xs])
    result = np.copy(image)
    result[(halo > 0) & (result == 0)] = 1.0
    return result


def pixels_overlap(canvas: np.ndarray, image: np.ndarray,
                   x: int, y: int) -> bool:
    """True if pasting ``image`` at (x, y) would overlap existing ink
    (reference multi_mnist.py:61-65)."""
    h, w = image.shape
    window = canvas[y:y + h, x:x + w]
    return bool(np.any((image > 0) & (window > 0)))


def bounding_boxes_overlap(x, y, w, h, positions, boxes, gap) -> bool:
    """Correct AABB overlap (with ``gap`` margin) against placed digits."""
    for i in range(len(positions) // 2):
        px, py = positions[i * 2:(i + 1) * 2]
        bw, bh = boxes[i * 2:(i + 1) * 2]
        l1x, l1y = x - gap, y - gap
        r1x, r1y = x + w + gap - 1, y + h + gap - 1
        l2x, l2y, r2x, r2y = px, py, px + bw - 1, py + bh - 1
        if l1x <= r2x and l2x <= r1x and l1y <= r2y and l2y <= r1y:
            return True
    return False


class DigitStream:
    """Reshuffling stream over the digit pool — the reference's
    digit_ids / next_digit_id globals (multi_mnist.py:104-108,341-346)."""

    def __init__(self, num_digits: int, rng: np.random.Generator):
        self.rng = rng
        self.ids = rng.permutation(num_digits)
        self.pos = 0

    def next(self) -> int:
        idx = int(self.ids[self.pos])
        self.pos += 1
        if self.pos >= len(self.ids):
            self.ids = self.rng.permutation(self.ids)
            self.pos = 0
        return idx


def generate_multi_image(single_images, num_digits, image_dim, canvas_dim,
                         stream: DigitStream, rng: np.random.Generator,
                         bg=None, min_w=1.0, max_w=1.0, min_h=1.0,
                         max_h=1.0, min_ang=0.0, max_ang=0.0,
                         gap=0, margin=0, use_pixel_overlap=True):
    """One canvas with ``num_digits`` non-overlapping digits
    (reference multi_mnist.py:82-183).

    Returns (canvas [canvas_dim, canvas_dim], ids, positions, boxes).
    """
    while True:
        canvas = np.zeros((canvas_dim, canvas_dim), np.float32)
        canvas_with_buffer = canvas
        placed_ids, placed_positions, placed_boxes = [], [], []

        if num_digits == 0:
            break

        ok = True
        for i in range(num_digits):
            idx = stream.next()
            image = np.reshape(single_images[idx], (image_dim, image_dim))
            image = crop_non_empty(image)

            if (min_w, max_w, min_h, max_h) != (1.0, 1.0, 1.0, 1.0):
                if nd is None:
                    raise RuntimeError("scipy required for digit rescaling")
                new_width = rng.uniform(min_w, max_w)
                new_height = rng.uniform(min_h, max_h)
                image = nd.affine_transform(
                    image,
                    matrix=np.array([[1.0 / new_height, 0.0],
                                     [0.0, 1.0 / new_width]]),
                    output_shape=(int(image_dim * new_height),
                                  int(image_dim * new_width)),
                    order=5)
                image = np.clip(image, 0.0, 1.0)
                image = np.where(image >= 0.05, image, 0.0)
                image = crop_non_empty(image)

            if (min_ang, max_ang) != (0.0, 0.0):
                if nd is None:
                    raise RuntimeError("scipy required for digit rotation")
                angle = rng.uniform(min_ang, max_ang)
                image = nd.rotate(image, angle, order=5)
                image = np.clip(image, 0.0, 1.0)
                image = np.where(image >= 0.05, image, 0.0)
                image = crop_non_empty(image)

            h, w = image.shape
            found = False
            for _ in range(100):
                x = int(rng.integers(margin, canvas_dim - w - margin + 1))
                y = int(rng.integers(margin, canvas_dim - h - margin + 1))
                if i == 0:
                    found = True
                elif use_pixel_overlap:
                    found = not pixels_overlap(canvas_with_buffer, image, x, y)
                else:
                    found = not bounding_boxes_overlap(
                        x, y, w, h, placed_positions, placed_boxes, gap)
                if found:
                    break

            if not found:
                ok = False       # retry the whole canvas
                break

            canvas[y:y + h, x:x + w] += image
            if use_pixel_overlap and num_digits > 1:
                canvas_with_buffer = (add_buffer(canvas, gap)
                                      if gap > 0 else canvas)
            placed_positions.extend([x, y])
            placed_boxes.extend([w, h])
            placed_ids.append(idx)

        if ok:
            break

    if bg is not None:
        canvas = np.clip(canvas + bg, 0.0, 1.0)

    return canvas, placed_ids, placed_positions, placed_boxes


@dataclasses.dataclass
class MultiMNISTConfig:
    """Generator CLI knobs — same 13+2 flags as the reference
    (reference multi_mnist.py:312-329)."""
    max_digits: int = 2
    max_in_common: int = 2
    images_per_digit: int = 20000
    test_set_size: int = 1000
    digit_gap: int = 0
    canvas_margin: int = 0
    bg_path: str = ""
    bg_max_intensity: float = 1.0
    min_width_scale: float = 1.0
    max_width_scale: float = 1.0
    min_height_scale: float = 1.0
    max_height_scale: float = 1.0
    min_rotation_angle: float = 0.0
    max_rotation_angle: float = 0.0
    use_bounding_box_overlap: bool = False
    canvas_size: int = 50
    image_size: int = 28
    seed: int = 0
    # procedural background (air_tpu_torch.data.backgrounds) as an alternative to
    # bg_path: one of noise/gradient/stripes/blobs/checker, or "" for none
    bg_kind: str = ""


def generate_dataset(single_images, single_labels, config: MultiMNISTConfig,
                     out_dir: str | None = None, progress=None):
    """Full stratified generation + common/test split
    (reference multi_mnist.py:299-414).

    Returns a dict with per-stratum and split arrays; writes AIRREC files
    into ``out_dir`` if given (``<k>.airrec`` per stratum plus
    ``common.airrec`` / ``test.airrec``).
    """
    from air_tpu_torch.data.records import write_records

    cfg = config
    rng = np.random.default_rng(cfg.seed)
    stream = DigitStream(len(single_images), rng)
    bg = prepare_background(cfg.canvas_size, bg_path=cfg.bg_path,
                            bg_kind=cfg.bg_kind,
                            max_intensity=cfg.bg_max_intensity,
                            seed=cfg.seed)

    common = {k: [] for k in
              ("images", "indices", "positions", "boxes", "labels", "digits")}
    strata = {}
    used_digit_ids = set()

    for num_digits in range(cfg.max_digits + 1):
        s_images, s_indices, s_positions, s_boxes, s_labels = \
            [], [], [], [], []
        for item in range(cfg.images_per_digit):
            img, ids, pos, box = generate_multi_image(
                single_images, num_digits, cfg.image_size, cfg.canvas_size,
                stream, rng, bg=bg,
                min_w=cfg.min_width_scale, max_w=cfg.max_width_scale,
                min_h=cfg.min_height_scale, max_h=cfg.max_height_scale,
                min_ang=cfg.min_rotation_angle, max_ang=cfg.max_rotation_angle,
                gap=cfg.digit_gap, margin=cfg.canvas_margin,
                use_pixel_overlap=not cfg.use_bounding_box_overlap)
            if num_digits <= cfg.max_in_common:
                used_digit_ids.update(ids)
            s_images.append(img)
            s_indices.append(ids)
            s_positions.append(pos)
            s_boxes.append(box)
            s_labels.append(list(np.asarray(single_labels)[ids]))
            if progress and (item + 1) % 1000 == 0:
                progress(num_digits, item + 1)

        s_digits = [num_digits] * cfg.images_per_digit
        strata[num_digits] = dict(images=s_images, indices=s_indices,
                                  positions=s_positions, boxes=s_boxes,
                                  labels=s_labels, digits=s_digits)
        if num_digits <= cfg.max_in_common:
            for k, v in (("images", s_images), ("indices", s_indices),
                         ("positions", s_positions), ("boxes", s_boxes),
                         ("labels", s_labels), ("digits", s_digits)):
                common[k].extend(v)
        if out_dir:
            write_records(f"{out_dir}/{num_digits}", s_images, s_digits,
                          s_indices, s_positions, s_boxes, s_labels,
                          max_digits=cfg.max_digits)

    # shuffle common pool, split off the test set
    # (reference multi_mnist.py:394-414)
    perm = rng.permutation(len(common["images"]))
    for k in common:
        common[k] = [common[k][i] for i in perm]
    t = cfg.test_set_size
    split = {
        "test": {k: v[:t] for k, v in common.items()},
        "common": {k: v[t:] for k, v in common.items()},
    }
    if out_dir:
        for name, d in split.items():
            write_records(f"{out_dir}/{name}", d["images"], d["digits"],
                          d["indices"], d["positions"], d["boxes"],
                          d["labels"], max_digits=cfg.max_digits)

    return {"strata": strata, **split, "used_digit_ids": used_digit_ids}
