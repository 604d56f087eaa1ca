"""PNG I/O.  Writing needs only the standard library (``zlib`` +
``struct``), so SR images can be saved on a machine without Pillow;
reading other files imports Pillow lazily."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """HWC uint8 RGB -> PNG bytes (8-bit truecolor, filter 0 per row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img.dtype}")
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected HWC RGB, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def imwrite_uint8(path: Union[str, os.PathLike], img: np.ndarray) -> None:
    """Write an HWC uint8 RGB array as PNG (dirs created as needed)."""
    path = os.fspath(path)
    data = encode_png(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def imread_uint8(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read an image file as HWC uint8 RGB (needs Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs Pillow, which is not "
                          f"installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
