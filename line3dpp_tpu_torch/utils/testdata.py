"""Loader for the repository's bundled test scene.

``testdata/cameras_testdata.json`` holds the 26 cameras (K, R, t, image size)
and ``testdata/L3D_cache/`` one cached segment file per view, keyed as
:mod:`segments_cache` writes them.  The loader returns plain numpy arrays so
that callers can build camera objects of either package from the same
numbers.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from . import segments_cache

TESTDATA_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "testdata"))


@dataclasses.dataclass
class BundledView:
    cam_id: int
    K: np.ndarray          # (3, 3) f64
    R: np.ndarray          # (3, 3) f64
    t: np.ndarray          # (3,) f64
    width: int
    height: int
    segments: np.ndarray   # (n, 4) f64 cached detections


def load_views(cam_ids=None, testdata_dir: str = TESTDATA_DIR,
               max_segments: int = 3000) -> list[BundledView]:
    """The bundled views in ascending camera id (all 26 by default)."""
    with open(os.path.join(testdata_dir, "cameras_testdata.json")) as f:
        cams = json.load(f)
    ids = sorted(int(c) for c in cams) if cam_ids is None else list(cam_ids)
    cache_dir = os.path.join(testdata_dir, "L3D_cache")
    views = []
    for cam_id in ids:
        c = cams[str(cam_id)]
        segs = segments_cache.load(cache_dir, cam_id,
                                   (c["height"], c["width"]), max_segments)
        if segs is None:
            raise FileNotFoundError(
                f"no cached segments for view {cam_id} in {cache_dir}")
        views.append(BundledView(
            cam_id=cam_id, K=np.array(c["K"], np.float64),
            R=np.array(c["R"], np.float64), t=np.array(c["t"], np.float64),
            width=int(c["width"]), height=int(c["height"]), segments=segs))
    return views


def load_colmap_views(testdata_dir: str = TESTDATA_DIR,
                      max_segments: int = 3000) -> list[tuple]:
    """The COLMAP text model ``testdata/colmap_model/`` (the 26 views with
    their worldpoints) read with :func:`line3dpp_tpu_torch.io.read_colmap`,
    each with its cached segments: ``(cam_id, view, segments)`` in model
    order.  COLMAP image ids are 1-based; ``cam_id`` is the id minus one,
    the cache's 0-based id (the photos are not in the repository, so the
    segments come from the cache, as a detection would read them)."""
    from ..io import read_colmap

    cache_dir = os.path.join(testdata_dir, "L3D_cache")
    out = []
    for v in read_colmap(os.path.join(testdata_dir, "colmap_model"),
                         testdata_dir):
        segs = segments_cache.load(cache_dir, v.cam_id - 1,
                                   (v.height, v.width), max_segments)
        if segs is None:
            raise FileNotFoundError(
                f"no cached segments for view {v.cam_id - 1} in {cache_dir}")
        out.append((v.cam_id - 1, v, segs))
    return out
