"""On-disk cache of detected 2D segments.

Mirrors the reference's per-image segment caches (reference:
line3D.cc:296-309, 362-366) with `.npz` files keyed as ``line3dpp_tpu``'s
cache is, so both packages read and write the same files.  Importing a
reference Line3D++ ``.bin`` cache is ROADMAP item 12.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def _path(cache_dir: str, cam_id: int, shape, max_segments: int,
          max_width: int = -1) -> str:
    h, w = shape[0], shape[1]
    # the detection width is part of the key (the reference embeds the
    # processed image size in its cache filename, line3D.cc:296-309)
    wtag = "FULL" if max_width <= 0 or max_width >= w else str(max_width)
    return os.path.join(
        cache_dir,
        f"segments_L3DTPU_{cam_id}_{w}x{h}_W{wtag}_{max_segments}.npz")


def load(cache_dir: str, cam_id: int, shape, max_segments: int,
         max_width: int = -1) -> np.ndarray | None:
    """Cached (n, 4) segments of view ``cam_id``, or None when not cached."""
    p = _path(cache_dir, cam_id, shape, max_segments, max_width)
    if os.path.exists(p):
        with np.load(p) as data:
            return data["segments"]
    if glob.glob(os.path.join(cache_dir, f"segments_L3D++_{cam_id}_*.bin")):
        raise NotImplementedError(
            "importing reference Line3D++ .bin segment caches is not ported "
            "yet (ROADMAP item 12)")
    return None


def store(cache_dir: str, cam_id: int, shape, max_segments: int,
          segments: np.ndarray, max_width: int = -1) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(
        _path(cache_dir, cam_id, shape, max_segments, max_width),
        segments=np.asarray(segments, dtype=np.float64),
    )
