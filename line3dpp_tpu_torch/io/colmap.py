"""COLMAP sparse-model reader (reference executable: main_colmap.cpp).

Reads both the text export (`cameras.txt` / `images.txt` / `points3D.txt`,
the only format the reference supports) and COLMAP's default **binary**
export (`cameras.bin` / `images.bin` / `points3D.bin`), auto-detected.
Supported camera models (main_colmap.cpp:173-220): SIMPLE_PINHOLE, PINHOLE,
SIMPLE_RADIAL, RADIAL, OPENCV, FULL_OPENCV.  Worldpoint depths come from
points3D tracks (main_colmap.cpp:391-407); image->camera indirection is
preserved.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..camera import rotation_from_quaternion
from .types import SfMView, loud_parser

_MODELS = {
    "SIMPLE_PINHOLE": ("f", "cx", "cy"),
    "PINHOLE": ("fx", "fy", "cx", "cy"),
    "SIMPLE_RADIAL": ("f", "cx", "cy", "k1"),
    "RADIAL": ("f", "cx", "cy", "k1", "k2"),
    "OPENCV": ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
    "FULL_OPENCV": ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                    "k3", "k4", "k5", "k6"),
}

# COLMAP binary model ids -> (name, num_params)
_MODEL_IDS = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 6: "FULL_OPENCV",
}
_MODEL_NPARAMS = {
    0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12,
}


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def _kvals_to_K_dist(model: str, vals: dict):
    fx = vals.get("fx", vals.get("f"))
    fy = vals.get("fy", vals.get("f"))
    K = np.array([[fx, 0, vals["cx"]], [0, fy, vals["cy"]], [0, 0, 1.0]])
    dist = np.array([vals.get("k1", 0.0), vals.get("k2", 0.0),
                     vals.get("k3", 0.0), vals.get("p1", 0.0),
                     vals.get("p2", 0.0)])
    return K, dist


def _read_colmap_bin(model_dir: str, image_dir: str) -> list[SfMView]:
    """COLMAP binary sparse model (little-endian structs)."""
    def rd(f, fmt):
        return struct.unpack("<" + fmt, f.read(struct.calcsize("<" + fmt)))

    cameras = {}
    with open(os.path.join(model_dir, "cameras.bin"), "rb") as f:
        (n_cams,) = rd(f, "Q")
        for _ in range(n_cams):
            cam_id, model_id = rd(f, "ii")
            w, h = rd(f, "QQ")
            if model_id not in _MODEL_NPARAMS:
                raise ValueError(
                    f"unknown COLMAP camera model id {model_id}")
            params = rd(f, "d" * _MODEL_NPARAMS[model_id])
            if model_id not in _MODEL_IDS:
                raise ValueError(
                    f"unsupported COLMAP camera model id {model_id}")
            names = _MODELS[_MODEL_IDS[model_id]]
            vals = dict(zip(names, params))
            K, dist = _kvals_to_K_dist(_MODEL_IDS[model_id], vals)
            cameras[cam_id] = (K, dist, int(w), int(h))

    views: dict[int, SfMView] = {}
    with open(os.path.join(model_dir, "images.bin"), "rb") as f:
        (n_imgs,) = rd(f, "Q")
        for _ in range(n_imgs):
            (img_id,) = rd(f, "i")
            q = rd(f, "dddd")
            t = np.array(rd(f, "ddd"))
            (cam_id,) = rd(f, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00" or not c:
                    break
                name += c
            (n_pts2d,) = rd(f, "Q")
            f.seek(n_pts2d * (8 + 8 + 8), os.SEEK_CUR)  # xy + point3D_id
            K, dist, w, h = cameras[cam_id]
            views[img_id] = SfMView(
                cam_id=img_id, K=K.copy(), R=rotation_from_quaternion(q),
                t=t, image_path=os.path.join(image_dir, name.decode()),
                width=w, height=h, distortion=dist.copy(), worldpoints=[],
            )

    depths: dict[int, list[float]] = {i: [] for i in views}
    p3d = os.path.join(model_dir, "points3D.bin")
    if os.path.exists(p3d):
        with open(p3d, "rb") as f:
            (n_pts,) = rd(f, "Q")
            for _ in range(n_pts):
                (wp_id,) = rd(f, "q")
                X = np.array(rd(f, "ddd"))
                f.seek(3 + 8, os.SEEK_CUR)          # rgb + error
                (track_len,) = rd(f, "Q")
                for _ in range(track_len):
                    img_id, _p2d = rd(f, "ii")
                    if img_id in views:
                        v = views[img_id]
                        v.worldpoints.append(int(wp_id))
                        depths[img_id].append(
                            float(np.linalg.norm(X + v.R.T @ v.t)))

    out = []
    for img_id in sorted(views):
        v = views[img_id]
        if depths[img_id]:
            v.median_depth = float(np.median(depths[img_id]))
        out.append(v)
    return out


@loud_parser("COLMAP")
def read_colmap(model_dir: str, image_dir: str) -> list[SfMView]:
    if (not os.path.exists(os.path.join(model_dir, "cameras.txt"))
            and os.path.exists(os.path.join(model_dir, "cameras.bin"))):
        return _read_colmap_bin(model_dir, image_dir)
    cameras = {}
    for line in _data_lines(os.path.join(model_dir, "cameras.txt")):
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        w, h = int(parts[2]), int(parts[3])
        if model not in _MODELS:
            raise ValueError(f"unsupported COLMAP camera model {model}")
        names = _MODELS[model]
        vals = dict(zip(names, map(float, parts[4 : 4 + len(names)])))
        fx = vals.get("fx", vals.get("f"))
        fy = vals.get("fy", vals.get("f"))
        K = np.array([[fx, 0, vals["cx"]], [0, fy, vals["cy"]], [0, 0, 1.0]])
        dist = np.array([vals.get("k1", 0.0), vals.get("k2", 0.0),
                         vals.get("k3", 0.0), vals.get("p1", 0.0),
                         vals.get("p2", 0.0)])
        cameras[cam_id] = (K, dist, w, h)

    def _is_pose_line(line: str) -> bool:
        # pose: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME — the name is
        # non-numeric; observation lines are pure number triples
        parts = line.split()
        if len(parts) < 10:
            return False
        try:
            float(parts[9])
            return False
        except ValueError:
            return True

    views: dict[int, SfMView] = {}
    lines = list(_data_lines(os.path.join(model_dir, "images.txt")))
    # images.txt alternates pose / observation lines, but an image with zero
    # keypoints has an EMPTY observation line which _data_lines drops — so
    # detect pose lines structurally instead of assuming strict alternation
    i = 0
    while i < len(lines):
        if not _is_pose_line(lines[i]):
            i += 1
            continue
        parts = lines[i].split()
        i += 1
        if i < len(lines) and not _is_pose_line(lines[i]):
            i += 1                                  # skip the observation line
        img_id = int(parts[0])
        q = list(map(float, parts[1:5]))
        t = np.array(list(map(float, parts[5:8])))
        cam_id = int(parts[8])
        name = parts[9]
        K, dist, w, h = cameras[cam_id]
        views[img_id] = SfMView(
            cam_id=img_id, K=K.copy(), R=rotation_from_quaternion(q), t=t,
            image_path=os.path.join(image_dir, name), width=w, height=h,
            distortion=dist.copy(), worldpoints=[],
        )

    depths: dict[int, list[float]] = {i: [] for i in views}
    p3d = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(p3d):
        for line in _data_lines(p3d):
            parts = line.split()
            wp_id = int(parts[0])
            X = np.array(list(map(float, parts[1:4])))
            track = parts[8:]
            for j in range(0, len(track), 2):
                img_id = int(track[j])
                if img_id in views:
                    v = views[img_id]
                    v.worldpoints.append(wp_id)
                    # Euclidean distance to center (main_colmap.cpp:400)
                    depths[img_id].append(
                        float(np.linalg.norm(X + v.R.T @ v.t)))

    out = []
    for img_id in sorted(views):
        v = views[img_id]
        if depths[img_id]:
            v.median_depth = float(np.median(depths[img_id]))
        out.append(v)
    return out
