"""Scene-2 transfer check of the anchored (bridge-resistant) clustering
knob ``cluster_strong_min`` (``ops/clustering.cluster_edges_anchored``).

    python -m line3dpp_tpu_torch.tools.validate_scene2_anchor [--cpu] [--quick]

The port's counterpart of ``tools/validate_scene2_anchor.py``: the facade
and ground truth of ``validate_scene2``, ``cluster_strong_min`` swept over
{0, 1, 2, 3} under ``Config(num_neighbors=6)`` (line bundling on), to see
whether two-tier clustering transfers off the golden testdata.  The
detections are shared through ``validate_scene2.cache_dir``, named by the
camera geometry (the JAX tool uses one fixed directory).
"""

from __future__ import annotations

import sys
import time

from . import device_for
from .validate_scene2 import reconstruct, render_views, scores

ANCHORS = (0.0, 1.0, 2.0, 3.0)


def options(anchor: float) -> dict:
    """The ``Config`` options of one value of the sweep."""
    return dict(num_neighbors=6, cluster_strong_min=anchor)


def sweep(images, cams, gt, device) -> list[dict]:
    """One row per value of ``ANCHORS`` (``lines`` the count, ``lines3d``
    the lines, the scores, ``seconds`` of wall time), printed as it comes
    and as a table at the end."""
    rows = []
    for anchor in ANCHORS:
        t0 = time.perf_counter()
        lines = reconstruct(options(anchor), images, cams, device).lines3d
        rows.append(dict(cluster_strong_min=anchor, lines=len(lines),
                         **scores(lines, gt),
                         seconds=time.perf_counter() - t0, lines3d=lines))
        r = rows[-1]
        print(f"anchor={anchor:<4} lines={len(lines):<4} "
              f"recall={r['recall']:.3f} precision={r['precision']:.3f} "
              f"count_f1={r['count_f1']:.3f}  ({r['seconds']:.1f}s)",
              flush=True)

    print("\n| cluster_strong_min | lines | recall | precision | count_f1 |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['cluster_strong_min']} | {r['lines']} | "
              f"{r['recall']:.3f} | {r['precision']:.3f} | "
              f"{r['count_f1']:.3f} |", flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    device = device_for("--cpu" in argv)
    images, cams, gt = render_views(6 if "--quick" in argv else 10)
    return sweep(images, cams, gt, device)


if __name__ == "__main__":
    main()
