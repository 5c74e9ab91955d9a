"""Bundler `bundle.rd.out` reader (reference executable: main_bundler.cpp).

Format: `# Bundle file v0.3`, `n_cams n_pts`, then per camera
`f k1 k2` + 3 rotation rows + translation row, then worldpoints
`xyz / rgb / n_views {cam key u v}...`.  Bundler's camera looks down -z, so
the 2nd and 3rd rotation/translation rows are negated to our convention
(main_bundler.cpp:184-211); the image list supplies filenames; principal
point defaults to the image center.
"""

from __future__ import annotations

import os

import numpy as np

from .types import SfMView, loud_parser


@loud_parser("bundler")
def read_bundler(bundle_path: str, image_dir: str,
                 image_list: str | None = None,
                 image_ext: str = ".jpg") -> list[SfMView]:
    with open(bundle_path) as f:
        lines = [l.strip() for l in f if l.strip()]
    if not lines[0].startswith("#"):
        raise ValueError("missing bundler header")
    n_cams, n_pts = map(int, lines[1].split())

    # image names: explicit list file, or sorted directory listing
    if image_list and os.path.exists(image_list):
        names = [l.split()[0] for l in open(image_list) if l.strip()][:n_cams]
    else:
        names = sorted(
            n for n in os.listdir(image_dir)
            if n.lower().endswith(image_ext.lower()))[:n_cams]

    idx = 2
    views: list[SfMView] = []
    flip = np.diag([1.0, -1.0, -1.0])
    for cam_id in range(n_cams):
        f_k1_k2 = list(map(float, lines[idx].split())); idx += 1
        R = np.array([list(map(float, lines[idx + r].split()))
                      for r in range(3)]); idx += 3
        t = np.array(list(map(float, lines[idx].split()))); idx += 1
        R = flip @ R
        t = flip @ t
        focal = f_k1_k2[0]
        K = np.array([[focal, 0, -1.0], [0, focal, -1.0], [0, 0, 1.0]])
        views.append(SfMView(
            cam_id=cam_id, K=K, R=R, t=t,
            image_path=os.path.join(image_dir, names[cam_id])
            if cam_id < len(names) else "",
            distortion=np.array([f_k1_k2[1], f_k1_k2[2], 0.0, 0.0, 0.0]),
            worldpoints=[],
        ))

    depths: list[list[float]] = [[] for _ in range(n_cams)]
    for wp_id in range(n_pts):
        if idx + 2 >= len(lines):
            break
        X = np.array(list(map(float, lines[idx].split()))); idx += 1
        idx += 1  # rgb
        view_rec = lines[idx].split(); idx += 1
        n_views = int(view_rec[0])
        for v in range(n_views):
            cam = int(view_rec[1 + v * 4])
            if 0 <= cam < n_cams:
                views[cam].worldpoints.append(wp_id)
                vv = views[cam]
                C_cam = -vv.R.T @ vv.t
                # Euclidean distance to center (main_bundler.cpp:250)
                depths[cam].append(float(np.linalg.norm(X - C_cam)))

    for v, ds in zip(views, depths):
        if ds:
            v.median_depth = float(np.median(ds))
    return views
