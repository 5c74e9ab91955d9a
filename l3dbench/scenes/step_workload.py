"""The device step's synthetic inputs of the repository's ``bench.py``
(``make_workload``, frozen here for a later cell that drives the step
alone): the eight arrays of ``forward_step``.
"""

from __future__ import annotations

import numpy as np

from .camera import (Camera, CameraBatch, fundamental_matrix,
                                median_center_translation, rotation_from_rpy)


def make_workload(V=26, S=3000, N=10, seed=0):
    """``bench.py``'s synthetic step inputs: 800 random 3D segments seen by
    ``V`` cameras of 3072 x 2304 on a line, each view filled up to ``S``
    segments with random 2D clutter, the ``N`` nearest views as
    neighbours.  Returns the eight arrays of ``forward_step`` (segments,
    mask, RtKinv, C, k_reg, neighbour ids, F, pair validity), equal bit
    for bit to ``bench.make_workload``'s from the same seed.  Below 800
    segments (where ``bench.make_workload`` raises) a view keeps the
    first ``S`` projections and no clutter, which sizes the CPU runs of
    ``tools/bench_scaling.py``."""
    rng = np.random.default_rng(seed)
    n_lines = 800
    P = rng.uniform([-4, -3, 8], [4, 3, 16], size=(n_lines, 3))
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.5, 2.0, size=(n_lines, 1))

    K = np.array([[2400.0, 0, 1536], [0, 2400.0, 1152], [0, 0, 1]])
    cams = []
    for i in range(V):
        R = rotation_from_rpy(rng.normal() * 0.03, -0.02 * i + 0.2,
                              rng.normal() * 0.03)
        C = np.array([0.35 * i - 4.5, rng.normal() * 0.1, rng.normal() * 0.1])
        cams.append(Camera(K, R, -R @ C, 3072, 2304))

    segs = np.zeros((V, S, 4), np.float32)
    mask = np.zeros((V, S), bool)
    for i, cam in enumerate(cams):
        sv = np.hstack([cam.project(P), cam.project(Q)]).astype(np.float32)
        # fill the remaining slots with clutter segments (a full load)
        n_fill = max(S - len(sv), 0)
        a = rng.uniform([0, 0], [3072, 2304], size=(n_fill, 2))
        ang = rng.uniform(0, 2 * np.pi, n_fill)
        ln = rng.uniform(20, 300, n_fill)
        b = a + np.stack([np.cos(ang), np.sin(ang)], -1) * ln[:, None]
        segs[i] = np.vstack([sv, np.hstack([a, b])])[:S]
        mask[i] = True

    translation = median_center_translation(cams)
    cb = CameraBatch.from_cameras(cams, sigma_p=2.5, translation=translation)
    centered = [Camera(c.K, c.R, -c.R @ (c.C - translation),
                       c.width, c.height) for c in cams]

    neighbor_ids = np.zeros((V, N), np.int32)
    pair_valid = np.zeros((V, N), bool)
    F = np.zeros((V, N, 3, 3), np.float32)
    for i in range(V):
        nbrs = sorted((j for j in range(V) if j != i),
                      key=lambda j: np.linalg.norm(cams[i].C - cams[j].C))
        for g, j in enumerate(nbrs[:N]):
            neighbor_ids[i, g] = j
            pair_valid[i, g] = True
            F[i, g] = fundamental_matrix(centered[i], centered[j])

    return (segs, mask, cb.RtKinv.astype(np.float32), cb.C.astype(np.float32),
            cb.k_reg.astype(np.float32), neighbor_ids, F, pair_valid)
