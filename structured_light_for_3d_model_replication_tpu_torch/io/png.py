"""Dependency-free RGB8 PNG encode/decode (stdlib zlib + struct), the port's
own copy of the JAX package's ``io/png.py``.

``png_bytes`` is the one encoder of rendered previews (the splat lane's
``render_png``); ``decode_png`` reads back what ``png_bytes`` wrote (filter
0 only) — a round-trip helper, not a general decoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG file bytes."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """(H, W, 3) uint8 → PNG file (path or binary file object)."""
    data = png_bytes(image)
    if hasattr(path, "write"):
        path.write(data)
        return
    with open(path, "wb") as f:
        f.write(data)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (as written by :func:`png_bytes`) → (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, w, h, idat = 8, 0, 0, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only 8-bit RGB supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    rows = np.frombuffer(zlib.decompress(idat),
                         np.uint8).reshape(h, 1 + w * 3)
    if np.any(rows[:, 0]):
        raise ValueError("only filter 0 supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
