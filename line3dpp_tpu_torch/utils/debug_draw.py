"""Debug visualization helpers.

The reference's View exposes manual debug drawing — detected segments,
single segments, and epipolar lines (reference: View::drawLineImage,
drawSingleLine, drawEpipolarLine view.h:68-71, view.cc:60-147) plus a
temp-result STL dump (line3D.cc:2530-2576).  PIL replaces OpenCV drawing,
as in ``line3dpp_tpu.utils.debug_draw``; it is imported where it is used,
so the package runs without it.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(image: np.ndarray):
    from PIL import Image

    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return Image.fromarray(img.astype(np.uint8))


def draw_segments(image: np.ndarray, segments: np.ndarray,
                  color=(255, 0, 0), width: int = 2):
    """All 2D segments over the image (View::drawLineImage equivalent)."""
    from PIL import ImageDraw

    im = _to_rgb(image)
    d = ImageDraw.Draw(im)
    for x1, y1, x2, y2 in np.asarray(segments).reshape(-1, 4):
        d.line([(x1, y1), (x2, y2)], fill=tuple(color), width=width)
    return np.asarray(im)


def draw_single_segment(image: np.ndarray, segment: np.ndarray,
                        color=(0, 255, 0), width: int = 3):
    """One highlighted segment (View::drawSingleLine equivalent)."""
    return draw_segments(image, np.asarray(segment).reshape(1, 4), color, width)


def draw_epipolar_line(image: np.ndarray, epi_line: np.ndarray,
                       color=(0, 0, 255), width: int = 2):
    """Homogeneous 2D line ax+by+c=0 clipped to the image
    (View::drawEpipolarLine equivalent)."""
    from PIL import ImageDraw

    a, b, c = np.asarray(epi_line, np.float64)
    H, W = np.asarray(image).shape[:2]
    pts = []
    if abs(b) > 1e-12:
        for x in (0.0, W - 1.0):
            y = -(a * x + c) / b
            if -1 <= y <= H:
                pts.append((x, y))
    if abs(a) > 1e-12:
        for y in (0.0, H - 1.0):
            x = -(b * y + c) / a
            if -1 <= x <= W:
                pts.append((x, y))
    im = _to_rgb(image)
    if len(pts) >= 2:
        d = ImageDraw.Draw(im)
        d.line([pts[0], pts[1]], fill=tuple(color), width=width)
    return np.asarray(im)


def save_temp_result_stl(path: str, est_P1: np.ndarray, est_P2: np.ndarray,
                         est_valid: np.ndarray) -> None:
    """Dump current per-segment 3D hypotheses as STL
    (saveTempResultAsSTL equivalent, line3D.cc:2530-2576)."""
    from .writers import FinalLine3D, save_stl

    P1 = np.asarray(est_P1).reshape(-1, 3)
    P2 = np.asarray(est_P2).reshape(-1, 3)
    ok = np.asarray(est_valid).reshape(-1)
    segs = np.concatenate([P1[ok], P2[ok]], axis=1)
    save_stl(path, [FinalLine3D(segs, np.zeros((0, 6)))])
