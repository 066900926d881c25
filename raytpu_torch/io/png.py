"""PNG output with the reference's exact quantisation.

The reference downloads the RGBA32F frame and converts per channel with a
Rust saturating float->u8 ``as`` cast — truncation toward zero, clamped to
[0, 255], NaN -> 0, alpha dropped, **no gamma or tone mapping**
(src/main.rs:324-365). The encoder is stdlib ``zlib`` + ``struct`` (8-bit
RGB, filter type 0 on every row), so nothing on the render path needs
Pillow."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def quantize_rgba32f(frame: np.ndarray) -> np.ndarray:
    """[H,W,4] f32 -> [H,W,3] u8 exactly like rgba32float_to_rgba8888."""
    rgb = frame[..., :3].astype(np.float64) * 255.0
    rgb = np.nan_to_num(rgb, nan=0.0, posinf=255.0, neginf=0.0)
    rgb = np.clip(np.trunc(rgb), 0.0, 255.0)
    return rgb.astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """[H,W,3] u8 -> PNG file bytes."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, frame: np.ndarray) -> None:
    """Save an RGBA32F frame as RGB8 PNG (src/main.rs:338-349)."""
    with open(path, "wb") as f:
        f.write(encode_png(quantize_rgba32f(frame)))
