"""The large synthetic scene of the repository's ``tools/bench_scale.py``
(``build_scene``, frozen here for a later cell of 100+ views): 1500 random
3D segments seen by ``V`` cameras of 3072 x 2304 on a line, each view
filled up to ``S`` segments with random 2D clutter.

``Source`` serves it as a cached-segments scene: the configuration's
``views`` and ``segments`` set ``V`` and ``S``, and the run's seed the
scene (every scene of a run is drawn from the seed and its index).
"""

from __future__ import annotations

import numpy as np

from .camera import Camera, rotation_from_rpy
from . import seed_words


def build_scene(V: int, S: int = 3000, seed: int = 0) -> list:
    """1500 random 3D segments seen by ``V`` cameras of 3072 x 2304 on a
    line, each view filled up to ``S`` segments with random 2D clutter;
    ``(Camera, segments)`` per view, equal bit for bit to the JAX tool's
    from the same seed."""
    rng = np.random.default_rng(seed)
    n_lines = 1500
    P = rng.uniform([-6, -4, 8], [6, 4, 18], size=(n_lines, 3))
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.5, 2.0, size=(n_lines, 1))

    K = np.array([[2400.0, 0, 1536], [0, 2400.0, 1152], [0, 0, 1]])
    views = []
    for i in range(V):
        R = rotation_from_rpy(rng.normal() * 0.02, -0.005 * i + 0.2,
                              rng.normal() * 0.02)
        C = np.array([0.12 * i - 0.06 * V, rng.normal() * 0.1,
                      rng.normal() * 0.1])
        cam = Camera(K, R, -R @ C, 3072, 2304)
        sv = np.hstack([cam.project(P), cam.project(Q)])
        inside = ((sv[:, [0, 2]] > 0) & (sv[:, [0, 2]] < 3072)).all(1) & (
            (sv[:, [1, 3]] > 0) & (sv[:, [1, 3]] < 2304)).all(1)
        sv = sv[inside]
        n_fill = max(0, S - len(sv))
        a = rng.uniform([0, 0], [3072, 2304], size=(n_fill, 2))
        ang = rng.uniform(0, 2 * np.pi, n_fill)
        ln = rng.uniform(20, 300, n_fill)
        b = a + np.stack([np.cos(ang), np.sin(ang)], -1) * ln[:, None]
        segs = np.vstack([sv, np.hstack([a, b])])[:S]
        views.append((cam, segs))
    return views


class Source:
    def __init__(self, config: dict, spec: dict, seed: int, device=None):
        self.V, self.S = int(config["views"]), int(config["segments"])
        self.seed = seed

    @property
    def views_per_scene(self) -> int:
        return self.V

    def scene(self, index: int) -> dict:
        seed = int(np.random.default_rng(
            seed_words(self.seed, index + 1)).integers(1 << 62))
        views = [(i, c.K, c.R, c.t, c.width, c.height, segs)
                 for i, (c, segs) in enumerate(build_scene(self.V, self.S,
                                                           seed))]
        return dict(kind="cached", index=index, views=views)
