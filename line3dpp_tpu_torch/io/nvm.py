"""VisualSfM `.nvm` reader (reference executable: main_vsfm.cpp:38-249).

NVM_V3 format: camera lines `name focal qw qx qy qz cx cy cz r 0`, then
worldpoints `x y z r g b n_meas {img feat u v}...`.  Camera rotation comes
from the quaternion, translation `t = -R C`; the single radial coefficient
is sign-flipped relative to our undistortion convention (main_vsfm.cpp:290);
the principal point defaults to the image center (main_vsfm.cpp:272-281).
Only the first model of a multi-model file is used (main_vsfm.cpp:40).
"""

from __future__ import annotations

import os

import numpy as np

from ..camera import rotation_from_quaternion
from .types import SfMView, loud_parser


@loud_parser("NVM")
def read_nvm(nvm_path: str, image_dir: str | None = None) -> list[SfMView]:
    image_dir = image_dir or os.path.dirname(os.path.abspath(nvm_path))
    with open(nvm_path) as f:
        tokens = f.read().split()

    it = iter(tokens)
    magic = next(it)
    if not magic.startswith("NVM_V3"):
        raise ValueError(f"not an NVM_V3 file: {nvm_path}")
    # optional calibration string "FixedK fx cx fy cy" may follow the magic
    first = next(it)
    if first == "FixedK":
        for _ in range(4):
            next(it)
        first = next(it)
    n_cams = int(first)

    views: list[SfMView] = []
    for cam_id in range(n_cams):
        name = next(it)
        focal = float(next(it))
        q = [float(next(it)) for _ in range(4)]
        C = np.array([float(next(it)) for _ in range(3)])
        r_dist = float(next(it))
        next(it)  # trailing 0
        R = rotation_from_quaternion(q)
        t = -R @ C
        path = name if os.path.isabs(name) else os.path.join(image_dir, name)
        # principal point = image center, filled in once the image is opened
        K = np.array([[focal, 0.0, -1.0], [0.0, focal, -1.0], [0.0, 0.0, 1.0]])
        views.append(SfMView(
            cam_id=cam_id, K=K, R=R, t=t, image_path=path,
            distortion=np.array([-r_dist, 0.0, 0.0, 0.0, 0.0]),
            worldpoints=[],
        ))

    n_pts = int(next(it))
    depths: list[list[float]] = [[] for _ in range(n_cams)]
    for wp_id in range(n_pts):
        X = np.array([float(next(it)) for _ in range(3)])
        for _ in range(3):
            next(it)  # rgb
        n_meas = int(next(it))
        for _ in range(n_meas):
            img = int(next(it))
            next(it)  # feature index
            next(it), next(it)  # u, v
            if 0 <= img < n_cams:
                views[img].worldpoints.append(wp_id)
                v = views[img]
                C_cam = -v.R.T @ v.t
                # reference uses Euclidean distance to the camera center,
                # not z-depth (main_vsfm.cpp:247)
                depths[img].append(float(np.linalg.norm(X - C_cam)))

    for v, ds in zip(views, depths):
        if ds:
            v.median_depth = float(np.median(ds))
    return views
