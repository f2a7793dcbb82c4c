"""PNG/BMP output (reference `WriteImage.cpp:8-32` BMP via stb) and the
display-transform path. Both encoders are hand-rolled on the standard
library: PNG is 8-bit RGB with one zlib stream, BMP is 24-bit bottom-up -
which matches our film convention directly, like stb's y-flip)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .color import agx_tonemap, linear_to_srgb


def to_display(image, tonemap: str = "srgb"):
    """Linear film [H, W, 3] -> uint8 display image (row 0 = bottom)."""
    img = np.asarray(image, np.float32)
    img = np.where(np.isfinite(img), img, 0.0)
    if tonemap == "agx":
        img = agx_tonemap(img)
        img = linear_to_srgb(img)
    elif tonemap == "srgb":
        img = linear_to_srgb(img)
    elif tonemap != "none":
        raise ValueError(tonemap)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(rgb) -> bytes:
    """[H, W, 3] uint8, row 0 = top -> PNG file bytes (filter type 0)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, 3 * w)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, image, tonemap: str = "srgb") -> None:
    """Write the film to PNG (flipped to top-down for display)."""
    with open(path, "wb") as f:
        f.write(encode_png(to_display(image, tonemap)[::-1]))


def write_bmp(path: str, image, tonemap: str = "srgb") -> None:
    """24-bit uncompressed BMP (reference `WriteImage::WriteBMP`,
    `WriteImage.cpp:8-32`). BMP stores rows bottom-up = our film order."""
    arr = to_display(image, tonemap)  # [H, W, 3], row 0 bottom
    h, w, _ = arr.shape
    row_size = (3 * w + 3) & ~3
    pad = row_size - 3 * w
    data_size = row_size * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", 14 + 40 + data_size, 0, 0, 14 + 40))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size,
                            2835, 2835, 0, 0))
        padding = b"\x00" * pad
        bgr = arr[:, :, ::-1]  # BMP is BGR
        for y in range(h):
            f.write(bgr[y].tobytes())
            f.write(padding)
