"""Procedural canvas backgrounds for the harder-scenes dataset variant.

The port's own copy of ``air_tpu/data/backgrounds.py``: the same textures
bit for bit.

The reference ships 19 PNG textures in ``backgrounds/`` consumed via
``--bg-path`` (reference multi_mnist.py:319,334). This module generates
comparable textures procedurally (value-noise octaves, gradients, stripes)
so the harder-scenes capability (BASELINE.json config 3) is fully
self-contained — any PNG can still be supplied via ``--bg-path``.
"""

from __future__ import annotations

import numpy as np


def _value_noise(rng: np.random.Generator, size: int, octaves=(4, 8, 16)):
    out = np.zeros((size, size), np.float32)
    amp = 1.0
    for cells in octaves:
        coarse = rng.uniform(0, 1, (cells + 1, cells + 1)).astype(np.float32)
        xs = np.linspace(0, cells, size)
        x0 = np.clip(xs.astype(int), 0, cells - 1)
        fx = (xs - x0).astype(np.float32)
        # bilinear upsample of the coarse lattice
        a = coarse[np.ix_(x0, x0)]
        b = coarse[np.ix_(x0, x0 + 1)]
        c = coarse[np.ix_(x0 + 1, x0)]
        d = coarse[np.ix_(x0 + 1, x0 + 1)]
        layer = (a * (1 - fx)[None, :] + b * fx[None, :]) * (1 - fx)[:, None] \
            + (c * (1 - fx)[None, :] + d * fx[None, :]) * fx[:, None]
        out += amp * layer
        amp *= 0.5
    out -= out.min()
    if out.max() > 0:
        out /= out.max()
    return out


def generate_background(kind: str, size: int = 50, seed: int = 0,
                        max_intensity: float = 0.3) -> np.ndarray:
    """One [size, size] float32 background texture in [0, max_intensity].

    kinds: noise, gradient, stripes, blobs, checker.
    """
    rng = np.random.default_rng(seed)
    if kind == "noise":
        bg = _value_noise(rng, size)
    elif kind == "gradient":
        ang = rng.uniform(0, 2 * np.pi)
        xs, ys = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
        bg = xs * np.cos(ang) + ys * np.sin(ang)
        bg -= bg.min()
        bg /= max(bg.max(), 1e-6)
    elif kind == "stripes":
        freq = rng.uniform(2, 6)
        phase = rng.uniform(0, 2 * np.pi)
        ang = rng.uniform(0, np.pi)
        xs, ys = np.meshgrid(np.arange(size), np.arange(size))
        bg = 0.5 * (1 + np.sin(2 * np.pi * freq / size
                               * (xs * np.cos(ang) + ys * np.sin(ang))
                               + phase))
    elif kind == "blobs":
        bg = np.zeros((size, size), np.float32)
        xs, ys = np.meshgrid(np.arange(size), np.arange(size))
        for _ in range(rng.integers(3, 7)):
            cx, cy = rng.uniform(0, size, 2)
            r = rng.uniform(size / 8, size / 3)
            bg += np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * r * r))
        bg /= max(bg.max(), 1e-6)
    elif kind == "checker":
        cell = int(rng.integers(4, 10))
        xs, ys = np.meshgrid(np.arange(size), np.arange(size))
        bg = (((xs // cell) + (ys // cell)) % 2).astype(np.float32)
        bg = 0.3 + 0.7 * bg
    else:
        raise ValueError(f"unknown background kind: {kind!r}")
    return (bg * max_intensity).astype(np.float32)


def estimate_background(images, digits=None) -> np.ndarray:
    """Per-pixel background estimate from a (possibly composited) train set.

    The harder-scenes generator composites ONE static texture ``bg`` into
    every canvas at a fixed intensity ``s`` (reference multi_mnist.py:319-334
    dimmer): ``image = clip(ink + s*bg, 0, 1)``. Hence:

      * 0-digit scenes ARE ``clip(s*bg)`` exactly (no ink at all), so their
        per-pixel mean recovers the background with zero noise;
      * failing that (no 0-digit stratum), the per-pixel MINIMUM over many
        scenes recovers ``clip(s*bg)`` wherever at least one scene leaves
        that pixel ink-free — essentially everywhere for sparse digits.

    ``images``: [N, canvas**2] (or [N, c, c]) floats in [0, 1];
    ``digits``: optional [N] per-scene digit counts (enables the exact
    0-digit path). Returns a flat [canvas**2] float32 estimate.
    """
    images = np.asarray(images, np.float32).reshape(len(images), -1)
    if digits is not None:
        digits = np.asarray(digits)
        zero = images[digits == 0]
        if len(zero):
            return zero.mean(axis=0)
    return images.min(axis=0)


def background_bank(size: int = 50, seed: int = 0, per_kind: int = 4,
                    max_intensity: float = 0.3) -> list[np.ndarray]:
    """A bank of textures (~19 like the reference's backgrounds/)."""
    kinds = ["noise", "gradient", "stripes", "blobs", "checker"]
    bank = []
    for i in range(per_kind):
        for j, k in enumerate(kinds):
            bank.append(generate_background(k, size, seed * 1000 + i * 10 + j,
                                            max_intensity))
    return bank[:19]
