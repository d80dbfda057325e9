"""Minimal 24-bit uncompressed BMP codec (pure numpy + struct).

The port's own copy of ``lfsr_tpu/tools/bmp.py``; tests hold the bytes it
writes equal to the JAX package's. The submission contract requires 24-bpp
uncompressed BMPs with a standard BITMAPFILEHEADER + BITMAPINFOHEADER
(magic 'BM', 24 bpp, compression 0); both the packager and the validator
use this codec.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_FILE_HEADER = struct.Struct("<2sIHHI")
_INFO_HEADER = struct.Struct("<IiiHHIIiiII")


def encode_bmp(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 RGB -> BMP bytes (bottom-up rows, BGR, 4-byte row pad)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_bmp takes [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    row_bytes = (w * 3 + 3) & ~3
    bgr = rgb[::-1, :, ::-1]  # bottom-up, channel-swapped
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    pixel_data = rows.tobytes()
    offset = _FILE_HEADER.size + _INFO_HEADER.size
    file_header = _FILE_HEADER.pack(b"BM", offset + len(pixel_data), 0, 0, offset)
    info_header = _INFO_HEADER.pack(
        _INFO_HEADER.size, w, h, 1, 24, 0, len(pixel_data), 2835, 2835, 0, 0
    )
    return file_header + info_header + pixel_data


def write_bmp(path: str | Path, rgb: np.ndarray) -> None:
    Path(path).write_bytes(encode_bmp(rgb))


def parse_header(data: bytes) -> dict | None:
    """BMP header metadata (the fields the validator checks)."""
    if len(data) < 54:
        return None
    magic, file_size, _, _, offset = _FILE_HEADER.unpack_from(data, 0)
    (
        hdr_size, width, height, planes, bpp, compression,
        img_size, _hres, _vres, _colors, _important,
    ) = _INFO_HEADER.unpack_from(data, 14)
    return {
        "magic": magic,
        "file_size": file_size,
        "data_offset": offset,
        "header_size": hdr_size,
        "width": width,
        "height": height,
        "color_planes": planes,
        "bits_per_pixel": bpp,
        "compression": compression,
        "image_size": img_size,
    }


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> [H, W, 3] uint8 RGB (24-bpp uncompressed only)."""
    info = parse_header(data)
    if info is None or info["magic"] != b"BM":
        raise ValueError("not a BMP file")
    if info["bits_per_pixel"] != 24 or info["compression"] != 0:
        raise ValueError("only 24-bpp uncompressed BMP supported")
    w, h = info["width"], abs(info["height"])
    top_down = info["height"] < 0
    row_bytes = (w * 3 + 3) & ~3
    raw = np.frombuffer(data, np.uint8, count=h * row_bytes, offset=info["data_offset"])
    rows = raw.reshape(h, row_bytes)[:, : w * 3].reshape(h, w, 3)
    rgb = rows[:, :, ::-1]
    return rgb if top_down else rgb[::-1]
