"""Cluster -> 3D line fitting (host numpy).

Each cluster of 2D segments (with 3D hypotheses) becomes one infinite 3D line:
center of gravity of all hypothesis endpoints + dominant eigenvector of the
scatter matrix (reference: get3DlineFromCluster line3D.cc:2155-2218).  All
clusters are fit at once with one batched ``eigh`` over [C, 3, 3].  A copy of
``line3dpp_tpu.ops.fitting``'s numpy variants.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ClusterLines(NamedTuple):
    P1: np.ndarray      # (C, 3)  line point  COG - dir
    P2: np.ndarray      # (C, 3)  line point  COG + dir
    valid: np.ndarray   # (C,)


def fit_lines_np(points, cluster_id, num_clusters: int) -> ClusterLines:
    pts = np.asarray(points, np.float64)
    cid = np.asarray(cluster_id, np.int64)
    counts = np.bincount(cid, minlength=num_clusters).astype(np.float64)
    sums = np.zeros((num_clusters, 3))
    np.add.at(sums, cid, pts)
    cog = sums / np.maximum(counts, 1.0)[:, None]

    outer = pts[:, :, None] * pts[:, None, :]
    sum_outer = np.zeros((num_clusters, 9))
    np.add.at(sum_outer, cid, outer.reshape(-1, 9))
    scat = sum_outer.reshape(-1, 3, 3) - counts[:, None, None] * (
        cog[:, :, None] * cog[:, None, :])

    _, vecs = np.linalg.eigh(scat)
    direction = vecs[:, :, 2]
    nrm = np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction / np.maximum(nrm, 1e-12)
    return ClusterLines(P1=cog - direction, P2=cog + direction,
                        valid=counts >= 2.0)


def project_members_onto_lines_np(line_P1, line_dir, cam_C, ray1, ray2):
    """Line parameters (s1, s2) of each member 2D segment projected onto its
    cluster's 3D line + validity (reference: project2DsegmentOnto3Dline
    line3D.cc:2221-2266).

    Closest point on line (P, u) to the ray (C, v):  s = (b e - c d)/(a c - b²).
    """
    line_P1 = np.asarray(line_P1, np.float64)
    line_dir = np.asarray(line_dir, np.float64)
    cam_C = np.asarray(cam_C, np.float64)

    def params(v):
        v = np.asarray(v, np.float64)
        w = line_P1 - cam_C
        a = np.sum(line_dir * line_dir, -1)
        b = np.sum(line_dir * v, -1)
        c = np.sum(v * v, -1)
        d = np.sum(line_dir * w, -1)
        e = np.sum(v * w, -1)
        denom = a * c - b * b
        ok = np.abs(denom) > 1e-12
        s = (b * e - c * d) / np.where(ok, denom, 1.0)
        return s, ok

    s1, ok1 = params(ray1)
    s2, ok2 = params(ray2)
    return s1, s2, ok1 & ok2
