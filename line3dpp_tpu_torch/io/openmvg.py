"""OpenMVG `sfm_data.json` reader (reference executable: main_openmvg.cpp).

Reads intrinsics (pinhole, pinhole_radial_k1/k3, pinhole_brown_t2,
main_openmvg.cpp:224-245), extrinsic poses (rotation + center), and the
structure section's observations for worldpoint overlap.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .types import SfMView, loud_parser


@loud_parser("OpenMVG sfm_data")
def read_openmvg(sfm_json: str, image_dir: str | None = None) -> list[SfMView]:
    data = json.load(open(sfm_json))
    root = data.get("root_path", "")
    image_dir = image_dir or root

    intrinsics = {}
    for rec in data.get("intrinsics", []):
        key = rec["key"]
        val = rec["value"]["ptr_wrapper"]["data"]
        f = float(val.get("focal_length", 0.0))
        pp = val.get("principal_point", [0.0, 0.0])
        w = int(val.get("width", -1))
        h = int(val.get("height", -1))
        dp = val.get("disto_k1", val.get("disto_k3", val.get("disto_t2", [])))
        dist = np.zeros(5)
        if dp:
            ks = list(map(float, dp))
            # [k1], [k1 k2 k3], or [k1 k2 k3 t1 t2]
            for idx, v in enumerate(ks[:3]):
                dist[idx] = v
            if len(ks) >= 5:
                dist[3], dist[4] = ks[3], ks[4]
        K = np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1.0]])
        intrinsics[key] = (K, dist, w, h)

    poses = {}
    for rec in data.get("extrinsics", []):
        val = rec["value"]
        R = np.array(val["rotation"], np.float64)
        C = np.array(val["center"], np.float64)
        poses[rec["key"]] = (R, -R @ C)

    views: dict[int, SfMView] = {}
    for rec in data.get("views", []):
        val = rec["value"]["ptr_wrapper"]["data"]
        view_id = int(val["id_view"])
        pose_id = int(val["id_pose"])
        intr_id = int(val["id_intrinsic"])
        if pose_id not in poses or intr_id not in intrinsics:
            continue   # unposed view
        K, dist, w, h = intrinsics[intr_id]
        R, t = poses[pose_id]
        name = val["filename"]
        local = val.get("local_path", "")
        views[view_id] = SfMView(
            cam_id=view_id, K=K.copy(), R=R, t=t,
            image_path=os.path.join(image_dir, local, name),
            width=w, height=h, distortion=dist.copy(), worldpoints=[],
        )

    depths: dict[int, list[float]] = {i: [] for i in views}
    for rec in data.get("structure", []):
        val = rec["value"]
        wp_id = int(rec["key"])
        X = np.array(val["X"], np.float64)
        for ob in val.get("observations", []):
            vid = int(ob["key"])
            if vid in views:
                v = views[vid]
                v.worldpoints.append(wp_id)
                # Euclidean distance to center (main_openmvg.cpp:356)
                depths[vid].append(float(np.linalg.norm(X + v.R.T @ v.t)))

    out = []
    for vid in sorted(views):
        v = views[vid]
        if depths[vid]:
            v.median_depth = float(np.median(depths[vid]))
        out.append(v)
    return out
