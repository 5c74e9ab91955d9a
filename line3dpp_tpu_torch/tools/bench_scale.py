"""Large-scene throughput: the blocked pipeline on a synthetic V-view scene.

    python -m line3dpp_tpu_torch.tools.bench_scale [V] [--knn=K] [--block=B] [--cpu]

The port's counterpart of ``tools/bench_scale.py``, with its arguments
(V = 104 views, ``--knn=10``, ``--block=26`` source views a block) and its
last line: one JSON object with ``views``, ``knn``, ``view_block``,
``match_s``, ``reconstruct_s``, ``images_per_sec``, ``lines`` and
``hbm_peak_gb``.  Each phase's time is read on the host clock after the
card has finished it; ``hbm_peak_gb`` is ``torch.cuda.max_memory_allocated``
over the run (null on the CPU).  Device memory stays O(view_block * S * M)
while V grows.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..camera import Camera, rotation_from_rpy
from ..config import Config
from ..models.pipeline import Line3D
from . import device_for, synchronize


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


def main(argv: list[str] | None = None) -> dict:
    """Runs the scene through ``Line3D`` and prints the JSON line; returns
    it as a dict."""
    argv = sys.argv[1:] if argv is None else argv
    device = device_for("--cpu" in argv)
    V = next((int(a) for a in argv if a.isdigit()), 104)
    knn = next((int(a.split("=")[1]) for a in argv
                if a.startswith("--knn=")), 10)
    block = next((int(a.split("=")[1]) for a in argv
                  if a.startswith("--block=")), 26)
    t0 = time.perf_counter()
    views = build_scene(V)
    print(f"scene built in {time.perf_counter() - t0:.1f}s", flush=True)

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pipe = Line3D(Config(optimize=False, view_block=block, knn=knn),
                  device=device)
    for i, (cam, segs) in enumerate(views):
        pipe.add_view(i, cam, segs)

    t0 = time.perf_counter()
    pipe.match_images()
    synchronize(device)
    t_match = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = pipe.reconstruct_3d_lines()
    synchronize(device)
    t_recon = time.perf_counter() - t0

    peak = (round(torch.cuda.max_memory_allocated() / (1 << 30), 2)
            if on_card else None)
    result = {
        "views": V,
        "knn": knn,
        "view_block": block,
        "match_s": round(t_match, 1),
        "reconstruct_s": round(t_recon, 1),
        "images_per_sec": round(V / (t_match + t_recon), 2),
        "lines": len(lines),
        "hbm_peak_gb": peak,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
