"""Drive the library end to end through its public API on a synthetic scene.

    python -m line3dpp_tpu_torch.tools.drive_synthetic [--cpu]

The port's counterpart of ``tools/drive_synthetic.py``: 12 random 3D
segments seen by 6 cameras of 1920 x 1080, each view given their exact
projections and 5 random spurious segments, through ``Line3D`` with
``Config(num_neighbors=5, max_line_segments=100, optimize=False)``.  It
writes ``out.txt``, ``out.stl`` and ``out.obj`` to the temporary directory
(``tempfile.gettempdir()``) and prints the metrics against the ground
truth at a 0.05 tolerance.  Expected: 12 lines, recall and precision 1.0.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from ..camera import Camera, rotation_from_rpy
from ..config import Config
from ..models.pipeline import Line3D
from ..utils.golden import segment_set_metrics
from . import device_for


def run(device: str, out_dir: str) -> tuple[list, dict]:
    """The scene of seed 42 through ``Line3D`` on ``device``, the three
    files written to ``out_dir``; returns the lines and the metrics."""
    rng = np.random.default_rng(42)
    # a house of lines: 12 3D segments seen by 6 cameras
    P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(12, 3))
    d = rng.normal(size=(12, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.8, 1.6, size=(12, 1))

    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    cams = []
    for i in range(6):
        R = rotation_from_rpy(rng.normal() * 0.02, -0.06 * i + 0.15,
                              rng.normal() * 0.02)
        C = np.array([0.6 * i - 1.5, rng.normal() * 0.05,
                      rng.normal() * 0.05])
        cams.append(Camera(K, R, -R @ C, 1920, 1080))

    pipe = Line3D(Config(num_neighbors=5, max_line_segments=100,
                         optimize=False), device=device)
    for i, cam in enumerate(cams):
        segs = np.hstack([cam.project(P), cam.project(Q)])
        # 5 random spurious segments per view
        junk = rng.uniform([0, 0, 0, 0], [1920, 1080, 1920, 1080],
                           size=(5, 4))
        pipe.add_view(i, cam, np.vstack([segs, junk]))

    pipe.match_images()
    lines = pipe.reconstruct_3d_lines()
    print(f"reconstructed {len(lines)} 3D lines", flush=True)
    pipe.save_txt(os.path.join(out_dir, "out.txt"))
    pipe.save_stl(os.path.join(out_dir, "out.stl"))
    pipe.save_obj(os.path.join(out_dir, "out.obj"))

    gt = np.hstack([P, Q])
    pred = (np.concatenate([l.segments3d for l in lines]) if lines
            else np.zeros((0, 6)))
    m = segment_set_metrics(pred, gt, tol=0.05)
    print("metrics vs ground truth:", m, flush=True)
    return lines, m


def main(argv: list[str] | None = None) -> tuple[list, dict]:
    argv = sys.argv[1:] if argv is None else argv
    return run(device_for("--cpu" in argv), tempfile.gettempdir())


if __name__ == "__main__":
    main()
