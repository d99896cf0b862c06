"""Minimal image output: PNG (pure stdlib zlib) and PPM writers (a copy of
``sdf3d_tpu/utils/image_io.py``, which is pure numpy)."""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """Clamp a float image in [0, 1]-ish range to uint8 (H, W, 3)."""
    arr = np.asarray(img, np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(img, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) float or uint8 image as 8-bit RGB PNG bytes."""
    arr = img if (isinstance(img, np.ndarray) and img.dtype == np.uint8) else to_uint8(img)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"expected RGB, got {c} channels")

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))  # filter 0 per row
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, compress_level))
        + chunk(b"IEND", b"")
    )


def write_png(path, img) -> None:
    """Write an (H, W, 3) float or uint8 image as an 8-bit RGB PNG."""
    pathlib.Path(path).write_bytes(encode_png(img))


def write_ppm(path, img) -> None:
    """Write an (H, W, 3) image as binary PPM (P6)."""
    arr = img if (isinstance(img, np.ndarray) and img.dtype == np.uint8) else to_uint8(img)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())
