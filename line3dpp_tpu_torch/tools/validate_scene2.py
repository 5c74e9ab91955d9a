"""Second-scene acceptance check: the rendered synthetic facade, scored
against its known ground-truth 3D lines, across the configuration axes
that were tuned on the golden testdata.

    python -m line3dpp_tpu_torch.tools.validate_scene2 [--cpu] [--quick]

The port's counterpart of ``tools/validate_scene2.py``.  It tests whether
``split_bimodal_t`` (cluster bimodal splitting) and
``match_symmetrization`` (ordered back-edges) are properties of the
geometry and not fits to the bundled testdata: the facade's nested window
frames project to close parallel line pairs (closer than the 1%
scene-scale tolerance) beside isolated long edges.  The images are
rendered (``utils/synthetic``: 10 views, 1024 x 768, 2x supersampled; 6
with ``--quick``), LSD detection runs for real, and each of the four
configurations (``CONFIGS``, ``Config(num_neighbors=6, optimize=False)``)
is scored by recall and precision of the 3D segments and by the maximum
1-1 line matching (``utils/golden.line_match_metrics``) at 1% of the scene
scale.  Prints a line per configuration, then a markdown table.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time

import numpy as np

from ..config import Config
from ..models.pipeline import Line3D
from ..utils import synthetic
from ..utils.golden import (line_match_metrics, scene_scale,
                            segment_set_metrics)
from . import device_for

SS = 2                     # supersampling factor of the tool's renders
# (split_bimodal_t, match_symmetrization)
CONFIGS = ((0.0, "ordered"), (1.1, "ordered"), (0.0, "full"), (1.1, "full"))


def options(split_t: float, sym: str, optimize: bool = False) -> dict:
    """The ``Config`` options of one configuration of the sweep."""
    return dict(num_neighbors=6, optimize=optimize, split_bimodal_t=split_t,
                match_symmetrization=sym)


def cache_dir(cams) -> str:
    """The segment cache shared by the configurations.  The cache is keyed
    (cam_id, W x H, max segments) as the reference's, not by pose, so a
    fixed directory would serve stale detections after a change of the
    cameras: the directory is named by the full camera geometry."""
    geo = hashlib.sha256(
        np.concatenate([np.ravel(a) for c in cams
                        for a in (c.K, c.R, c.t)]).tobytes()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"scene2_cache_{geo}")


def reconstruct(opts: dict, images, cams, device) -> Line3D:
    """``Line3D(Config(**opts))`` on ``device`` through ``add_images``
    (detections shared through ``cache_dir``), ``match_images`` and
    ``reconstruct_3d_lines``; returns the pipeline."""
    pipe = Line3D(Config(**opts), device=device)
    pipe.add_images([(i, cam, img) for i, (cam, img)
                     in enumerate(zip(cams, images))],
                    cache_dir=cache_dir(cams))
    pipe.match_images()
    pipe.reconstruct_3d_lines()
    return pipe


def run_config(images, cams, split_t, sym, optimize=False, device=None):
    """The lines of one configuration (the JAX tool's ``run_config``)."""
    return reconstruct(options(split_t, sym, optimize), images, cams,
                       device or device_for(False)).lines3d


def scores(lines, gt) -> dict:
    """Recall and precision of the 3D segments and count_f1 of the 1-1
    line matching against the ground truth, at 1% of its scene scale."""
    tol = 0.01 * scene_scale(gt)
    pred = (np.concatenate([l.segments3d for l in lines]) if lines
            else np.zeros((0, 6)))
    sm = segment_set_metrics(pred, gt, tol=tol)
    lm = line_match_metrics([l.segments3d for l in lines],
                            [gt[i:i + 1] for i in range(len(gt))], tol=tol)
    return dict(recall=sm["recall"], precision=sm["precision"],
                count_f1=lm["count_f1"])


def sweep(images, cams, gt, device) -> list[dict]:
    """The four configurations on ``images``: one row each (``lines`` the
    count, ``lines3d`` the lines, the scores, ``seconds`` of wall time,
    the first configuration's detection included), printed as it comes
    and as a table at the end."""
    rows = []
    for split_t, sym in CONFIGS:
        t0 = time.perf_counter()
        pipe = reconstruct(options(split_t, sym), images, cams, device)
        lines = pipe.lines3d
        rows.append(dict(split_bimodal_t=split_t, symmetrization=sym,
                         lines=len(lines), **scores(lines, gt),
                         seconds=time.perf_counter() - t0, lines3d=lines))
        r = rows[-1]
        print(f"split={split_t:<4} sym={sym:<8} lines={len(lines):<4} "
              f"recall={r['recall']:.3f} precision={r['precision']:.3f} "
              f"count_f1={r['count_f1']:.3f}  ({r['seconds']:.1f}s)",
              flush=True)

    print("\n| split_bimodal_t | symmetrization | lines | recall | "
          "precision | count_f1 |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['split_bimodal_t']} | {r['symmetrization']} | "
              f"{r['lines']} | {r['recall']:.3f} | {r['precision']:.3f} | "
              f"{r['count_f1']:.3f} |", flush=True)
    return rows


def render_views(V: int):
    """The facade's ``V`` views at the tool's size: (images, cameras, gt)."""
    quads, gt = synthetic.build_scene()
    cams = synthetic.make_cameras(V)
    t0 = time.perf_counter()
    images = [synthetic.render(c, quads, seed=100 + i, ss=SS)
              for i, c in enumerate(cams)]
    print(f"rendered {len(images)} views in {time.perf_counter() - t0:.1f}s "
          f"({len(gt)} ground-truth lines)", flush=True)
    return images, cams, gt


def main(argv: list[str] | None = None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    device = device_for("--cpu" in argv)
    images, cams, gt = render_views(6 if "--quick" in argv else 10)
    return sweep(images, cams, gt, device)


if __name__ == "__main__":
    main()
