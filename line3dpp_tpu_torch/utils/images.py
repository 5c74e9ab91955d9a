"""Grey-level image reading for the command line.

Binary 8-bit PGM and PPM files (``P5``/``P6``, maxval 255) are read with
numpy alone; every other format goes through Pillow, which this module
imports only when such a file is read.  An RGB image becomes grey with
Pillow's ``convert("L")`` luma, ``(19595 R + 38470 G + 7471 B + 2^15) >>
16``, so both routes give the same bytes.
"""

from __future__ import annotations

import numpy as np


def _pnm_header(data: bytes) -> tuple[bytes, list[int], int] | None:
    """(magic, [width, height, maxval], offset of the pixels) of a binary
    PGM/PPM, or None when ``data`` is not one."""
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        return None
    fields: list[int] = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":             # comment to end of line
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("malformed PNM header")
        fields.append(int(data[start:pos]))
    return magic, fields, pos + 1               # one whitespace byte


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 with Pillow's ``convert("L")``."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def read_gray(path: str) -> np.ndarray:
    """The image at ``path`` as a (H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    head = _pnm_header(data)
    if head is not None and head[1][2] == 255:
        magic, (w, h, _), off = head
        ch = 1 if magic == b"P5" else 3
        px = np.frombuffer(data, np.uint8, count=w * h * ch, offset=off)
        return px.reshape(h, w).copy() if ch == 1 else rgb_to_gray(
            px.reshape(h, w, 3))
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} needs Pillow, which is not installed; without "
            f"it only binary 8-bit PGM/PPM images are read") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def write_pgm(path: str, image: np.ndarray) -> None:
    """Write a (H, W) uint8 array as a binary PGM."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(image.tobytes())
