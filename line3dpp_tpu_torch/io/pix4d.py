"""Pix4D `1_initial/params/` reader (reference executable: main_pix4d.cpp).

Reads `<project>_calibrated_camera_parameters.txt`.  Per-image record
(main_pix4d.cpp:207-280):

    filename width height
    K row 0 / K row 1 / K row 2
    radial distortion (3 values)
    tangential distortion (2 values)
    camera center C (1 row; the reference converts t = -R C)
    R row 0 / R row 1 / R row 2

Worldpoint overlap comes from `<prefix>_tp_pix4d.txt` when present
(main_pix4d.cpp:283-380): string-keyed features observed per key image,
triangulated linearly when seen in >2 views; per-camera worldpoint lists +
median Euclidean depths feed neighbor selection.  Without the tracks file
the pipeline falls back to geometric neighbor selection.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .types import SfMView, loud_parser


def _triangulate_linear(obs, Ps):
    """Linear homogeneous (DLT) triangulation of one feature
    (main_pix4d.cpp linearHomTriangulation)."""
    A = []
    for cam_idx, (px, py) in obs:
        P = Ps[cam_idx]
        A.append(px * P[2] - P[0])
        A.append(py * P[2] - P[1])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return None
    return X[:3] / X[3]


def _read_tracks(path: str, views: list[SfMView]) -> None:
    """Parse the tp_pix4d tracks file and fill worldpoints/median depths."""
    raw2pos = {
        os.path.splitext(os.path.basename(v.image_path))[0]: i
        for i, v in enumerate(views)
    }
    Ps = []
    centers = []
    for v in views:
        Rt = np.hstack([v.R, v.t.reshape(3, 1)])
        Ps.append(v.K @ Rt)
        centers.append(-v.R.T @ v.t)

    feat_ids: dict[str, int] = {}
    feat_obs: list[list] = []
    cam_feats: dict[int, list[int]] = {i: [] for i in range(len(views))}
    key_pos = None
    for line in open(path):
        parts = line.split()
        if not parts or len(parts[0]) < 2:
            break
        if parts[0].startswith("-"):
            continue
        if len(parts) == 1:
            key_pos = raw2pos.get(parts[0])       # new key image
            continue
        if key_pos is None:
            continue
        fkey = parts[0]
        px, py = float(parts[1]), float(parts[2])
        fid = feat_ids.setdefault(fkey, len(feat_obs))
        if fid == len(feat_obs):
            feat_obs.append([])
        feat_obs[fid].append((key_pos, (px, py)))
        cam_feats[key_pos].append(fid)

    pos3d: dict[int, np.ndarray] = {}
    for fid, obs in enumerate(feat_obs):
        if len(obs) > 2:
            X = _triangulate_linear(obs, Ps)
            if X is not None and np.linalg.norm(X) > 1e-12:
                pos3d[fid] = X

    for i, v in enumerate(views):
        wps = [f for f in cam_feats[i] if f in pos3d]
        v.worldpoints = wps
        if wps:
            d = [float(np.linalg.norm(pos3d[f] - centers[i])) for f in wps]
            v.median_depth = float(np.median(d))


@loud_parser("Pix4D")
def read_pix4d(params_dir: str, image_dir: str) -> list[SfMView]:
    cands = glob.glob(os.path.join(params_dir,
                                   "*_calibrated_camera_parameters.txt"))
    if not cands:
        raise FileNotFoundError(
            f"no *_calibrated_camera_parameters.txt under {params_dir}")
    path = cands[0]

    raw = [l.strip() for l in open(path)]
    # skip any leading header/comment block: records start at the first line
    # whose first token looks like an image filename
    def is_image_line(l: str) -> bool:
        if not l:
            return False
        head = l.split()[0].lower()
        return head.endswith((".jpg", ".jpeg", ".png", ".tif", ".tiff"))

    i = 0
    while i < len(raw) and not is_image_line(raw[i]):
        i += 1

    views: list[SfMView] = []
    cam_id = 0
    while i < len(raw) and is_image_line(raw[i]):
        header = raw[i].split(); i += 1
        name = header[0]
        w = int(float(header[1])) if len(header) >= 3 else -1
        h = int(float(header[2])) if len(header) >= 3 else -1

        K = np.array([list(map(float, raw[i + r].split())) for r in range(3)])
        i += 3
        radial = list(map(float, raw[i].split())); i += 1
        tangential = list(map(float, raw[i].split())); i += 1
        C = np.array(list(map(float, raw[i].split()))); i += 1
        R = np.array([list(map(float, raw[i + r].split())) for r in range(3)])
        i += 3

        t = -R @ C                      # main_pix4d.cpp:270
        dist = np.zeros(5)
        dist[:3] = (radial + [0.0, 0.0, 0.0])[:3]
        dist[3:5] = (tangential + [0.0, 0.0])[:2]
        views.append(SfMView(
            cam_id=cam_id, K=K, R=R, t=t,
            image_path=os.path.join(image_dir, name), width=w, height=h,
            distortion=dist, worldpoints=None,
        ))
        cam_id += 1
        # tolerate blank separator lines between records
        while i < len(raw) and not raw[i]:
            i += 1

    tracks = path.replace("_calibrated_camera_parameters.txt",
                          "_tp_pix4d.txt")
    if os.path.exists(tracks):
        _read_tracks(tracks, views)
    return views
