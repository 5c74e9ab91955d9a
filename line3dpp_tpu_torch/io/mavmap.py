"""mavmap `image-data-*.txt` reader (reference executable: main_mavmap.cpp).

Comma-separated rows (main_mavmap.cpp:176-250):

    name, roll, pitch, yaw, lat, lon, alt, h, tx, ty, tz,
    camID, camModel, fx, fy, cx, cy

Rotation from roll/pitch/yaw; [R|t] is cam->world and gets inverted to our
world->cam convention (main_mavmap.cpp:220-231).  Only the PINHOLE camera
model is supported (main_mavmap.cpp:188-193); per-row fx/fy/cx/cy build each
camera's K.  mavmap scenes use *sequential* visual neighbors
(main_mavmap.cpp:311-321) — the caller wires those via
``Line3D.set_visual_neighbors`` (see :func:`sequential_neighbors`).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..camera import rotation_from_rpy
from .types import SfMView, loud_parser


@loud_parser("mavmap")
def read_mavmap(data_path: str, image_dir: str,
                K: np.ndarray | None = None,
                image_ext: str = ".jpg") -> list[SfMView]:
    """``K`` is an optional override; rows normally carry fx/fy/cx/cy."""
    if os.path.isdir(data_path):
        cands = sorted(glob.glob(os.path.join(data_path, "image-data-*.txt")))
        if not cands:
            raise FileNotFoundError(f"no image-data-*.txt under {data_path}")
        data_path = cands[-1]

    views: list[SfMView] = []
    cam_id = 0
    for line in open(data_path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.replace(",", " ").split()]
        name = parts[0]
        roll, pitch, yaw = map(float, parts[1:4])
        tx, ty, tz = map(float, parts[8:11])

        if len(parts) >= 17:
            cam_model = parts[12]
            if not cam_model.upper().startswith("PINHOLE"):
                raise ValueError(
                    f"only the PINHOLE camera model is supported "
                    f"(got {cam_model}; main_mavmap.cpp:188-193)")
            fx, fy, cx, cy = map(float, parts[13:17])
            Ki = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        elif K is not None:
            Ki = np.asarray(K, np.float64).copy()
        else:
            raise ValueError(
                "image-data row carries no intrinsics and no K override "
                "was provided")

        # mavmap stores cam->world; invert to world->cam
        Rcw = rotation_from_rpy(roll, pitch, yaw)
        Ccw = np.array([tx, ty, tz])
        R = Rcw.T
        t = -R @ Ccw

        if not os.path.splitext(name)[1]:
            name += image_ext
        views.append(SfMView(
            cam_id=cam_id, K=Ki, R=R, t=t,
            image_path=os.path.join(image_dir, name),
            distortion=None, worldpoints=None,
        ))
        cam_id += 1
    return views


def sequential_neighbors(n_views: int, window: int = 10) -> dict[int, list[int]]:
    """Sequential-capture neighbor window (main_mavmap.cpp:311-321)."""
    out = {}
    for i in range(n_views):
        nbrs = [j for d in range(1, window + 1) for j in (i - d, i + d)
                if 0 <= j < n_views]
        out[i] = nbrs[: window]
    return out
