"""Minimal stdlib-only PNG writing and display conversion.

The reference displays through a GL framebuffer blit
(src/main.cpp:959-965); the headless port writes PNG
frames. Pure zlib/struct — no imaging dependency.

Row order: framework images use row 0 = NDC y = -1 (bottom of the view, GL
texture convention); PNGs are stored top-row-first, so `write_png` flips
vertically by default to display upright.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def tonemap_to_u8(img: np.ndarray) -> np.ndarray:
    """float [0,1]-ish (H, W, 3) -> uint8, clipped (display already has the
    reference's pow(x, 0.45) applied at accumulation time, glsl:392)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str | Path, img: np.ndarray, flip_vertical: bool = True) -> Path:
    """Write an (H, W, 3) uint8 or float image as RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = tonemap_to_u8(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if flip_vertical:
        img = img[::-1]
    h, w, _ = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    path = Path(path)
    path.write_bytes(data)
    return path
