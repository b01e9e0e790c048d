"""A PNG reader without PIL: the port's backgrounds on a machine that has
no imaging library.

``read_png(path)`` decodes a non-interlaced PNG of bit depth 8 in colour
type 0 (grey), 2 (RGB), 3 (palette), 4 (grey and alpha) or 6 (RGBA): the
chunks' CRCs checked, the IDAT stream inflated by ``zlib``, each row
unfiltered by its filter type (0 none, 1 sub, 2 up, 3 average, 4 Paeth),
and palette indices looked up in PLTE. ``read_png_grey(path)`` converts to
grey as PIL's ``Image.convert("L")`` does, in its fixed point:
``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``; alpha is dropped, as PIL
drops it. Any other PNG (bit depth 1, 2, 4 or 16, Adam7 interlace) and any
file that is not a PNG raise ``ValueError`` naming what was met. The write
side is ``train/visualize.write_png``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each supported colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    """(kind, body) of each chunk, its CRC checked, up to IEND."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(bpp):
        out[i] = (out[i] + (prior[i] >> 1)) & 0xFF
    for i in range(bpp, len(out)):
        out[i] = (out[i] + ((out[i - bpp] + prior[i]) >> 1)) & 0xFF
    return out


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(bpp):                       # left and upper-left are 0
        out[i] = (out[i] + prior[i]) & 0xFF
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], prior[i], prior[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """[height, 1 + stride] filtered rows -> [height, stride] uint8."""
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = filt
        elif kind == 1:
            row = np.cumsum(filt.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = filt + prior
        elif kind == 3:
            row = np.frombuffer(_average_row(filt.tobytes(), prior.tobytes(),
                                             bpp), np.uint8)
        elif kind == 4:
            row = np.frombuffer(_paeth_row(filt.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def read_png(path: str) -> tuple[np.ndarray, int]:
    """(pixels, colour type) of an 8-bit non-interlaced PNG: pixels
    [H, W, C] uint8, C the colour type's samples (a palette image's
    indices looked up: [H, W, 3]). ``ValueError`` on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"{path}: colour type {color} is not a PNG colour "
                         "type")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} (only 8-bit PNGs are "
                         "read)")
    if interlace != 0:
        raise ValueError(f"{path}: Adam7 interlace (only non-interlaced "
                         "PNGs are read)")
    bpp = CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{width}x{height} at {bpp} bytes a pixel")
    pixels = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp,
                       path).reshape(height, width, bpp)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        if int(pixels.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past PLTE's "
                             f"{len(palette)} entries")
        pixels = palette[pixels[..., 0]]
    return pixels, color


def read_png_grey(path: str) -> np.ndarray:
    """[H, W] uint8: the PNG as PIL's ``Image.open(path).convert("L")``
    gives it (grey kept, RGB and palette colours through ITU-R 601-2 luma
    in PIL's fixed point, alpha dropped)."""
    pixels, color = read_png(path)
    if color in (0, 4):
        return pixels[..., 0].copy()
    rgb = pixels[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)
