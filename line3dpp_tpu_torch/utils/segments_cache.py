"""On-disk cache of detected 2D segments.

Mirrors the reference's per-image segment caches (reference:
line3D.cc:296-309, 362-366) with `.npz` files keyed as ``line3dpp_tpu``'s
cache is, so both packages read and write the same files.  Where a view has
no such file, a reference Line3D++ ``.bin`` cache of it is imported, as
``line3dpp_tpu`` imports it.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from . import ref_bin


def _path(cache_dir: str, cam_id: int, shape, max_segments: int,
          max_width: int = -1) -> str:
    h, w = shape[0], shape[1]
    # the detection width is part of the key (the reference embeds the
    # processed image size in its cache filename, line3D.cc:296-309)
    wtag = "FULL" if max_width <= 0 or max_width >= w else str(max_width)
    return os.path.join(
        cache_dir,
        f"segments_L3DTPU_{cam_id}_{w}x{h}_W{wtag}_{max_segments}.npz")


def _reference_path(cache_dir: str, cam_id: int, shape,
                    max_width: int = -1) -> str | None:
    """Locate a reference Line3D++ cache ``segments_L3D++_<cam>_<WxH>_*.bin``
    for this view, if one exists (line3D.cc:296-309).

    The reference embeds the PROCESSED (downscaled) image size in the
    filename; its downscale rule is max-dimension based (line3D.cc:271-293:
    ``s = max_image_width / max(rows, cols)``), so the expected size is
    recomputed here and matched with a small rounding tolerance.
    """
    cands = glob.glob(os.path.join(cache_dir,
                                   f"segments_L3D++_{cam_id}_*x*_*.bin"))
    if not cands:
        return None
    h0, w0 = int(shape[0]), int(shape[1])
    ew, eh = w0, h0
    if max_width > 0 and max(h0, w0) > max_width:
        s = max_width / max(h0, w0)
        ew, eh = round(w0 * s), round(h0 * s)

    best, best_err = None, 3  # accept <= 2 px resize-rounding difference
    for p in cands:
        m = re.search(r"_(\d+)x(\d+)_\d+\.bin$", os.path.basename(p))
        if not m:
            continue
        err = abs(int(m.group(1)) - ew) + abs(int(m.group(2)) - eh)
        if err < best_err:
            best, best_err = p, err
    return best


def load(cache_dir: str, cam_id: int, shape, max_segments: int,
         max_width: int = -1) -> np.ndarray | None:
    """Cached (n, 4) segments of view ``cam_id``, or None when not cached
    or unreadable (the view is then detected again).  Without the port's
    own file, a reference Line3D++ cache of the view (its coordinates
    already at full resolution) is imported, with a line saying so; an
    unreadable one gives None and a warning."""
    p = _path(cache_dir, cam_id, shape, max_segments, max_width)
    if os.path.exists(p):
        try:
            with np.load(p) as data:
                return data["segments"]
        except Exception:
            return None
    ref = _reference_path(cache_dir, cam_id, shape, max_width)
    if ref is None:
        return None
    try:
        segs = ref_bin.load_reference_segments_bin(ref)
    except Exception as e:
        print(f"[L3D-TPU] warning: unreadable reference segment cache "
              f"{ref}: {e}", flush=True)
        return None
    print(f"[L3D-TPU] imported {len(segs)} segments from reference cache "
          f"{os.path.basename(ref)}", flush=True)
    return segs


def store(cache_dir: str, cam_id: int, shape, max_segments: int,
          segments: np.ndarray, max_width: int = -1) -> None:
    """Write the cache file under a temporary name and rename it, so that
    an interrupted run leaves no truncated file."""
    os.makedirs(cache_dir, exist_ok=True)
    path = _path(cache_dir, cam_id, shape, max_segments, max_width)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, segments=np.asarray(segments, dtype=np.float64))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
