"""Write the JAX package's lines on the COLMAP model's 26 views, with the
worldpoint-overlap neighbours.

    JAX_PLATFORMS=cpu python tests/make_torch_colmap_reference.py \
        [--out tests/data/torch_colmap_26_jax_reference.npz]

Reads ``testdata/colmap_model/`` (a COLMAP text model of the 26 testdata
views with ~5k worldpoints) with the JAX package's ``read_colmap``, feeds
the 26 cached segment sets of ``testdata/L3D_cache/`` through
``Line3D.add_view(worldpoints=...)`` under ``Config(optimize=False)``, on
the CPU, and writes to the npz the final 3D lines (``line_counts``,
``lines``) and the neighbour table of the step (``neighbor_ids``).  COLMAP image ids are 1-based; the cache's are 0-based,
so each view is added as ``image id - 1`` (as
``tests/test_colmap_worldpoints_e2e.py`` does; the photos are not in the
repository).  Took 81 s on an 8-core CPU (peak 2.3 GB resident) and
stores 2,229 lines in 49 KB.  ``chip_smoke.py`` holds the port against this file on the card.
Not collected by pytest (its name does not start with test_).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEFAULT_OUT = os.path.join(REPO, "tests", "data",
                           "torch_colmap_26_jax_reference.npz")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    opts = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import line3dpp_tpu as l3d
    from line3dpp_tpu.io import read_colmap
    from line3dpp_tpu.utils import segments_cache

    t_all = time.perf_counter()
    testdata = os.path.join(REPO, "testdata")
    cache = os.path.join(testdata, "L3D_cache")
    views = read_colmap(os.path.join(testdata, "colmap_model"), testdata)
    pipe = l3d.Line3D(l3d.Config(optimize=False))
    for v in views:
        segs = segments_cache.load(cache, v.cam_id - 1, (v.height, v.width),
                                   pipe.config.max_line_segments)
        pipe.add_view(v.cam_id - 1,
                      l3d.Camera(v.K, v.R, v.t, v.width, v.height,
                                 median_depth=v.median_depth),
                      segs, worldpoints=v.worldpoints)
    assert len(pipe._views) == 26
    assert all(e.worldpoints for e in pipe._views.values())
    t0 = time.perf_counter()
    pipe.match_images()
    print(f"match_images: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pred = [l.segments3d for l in pipe.reconstruct_3d_lines()]
    print(f"reconstruct_3d_lines: {len(pred)} lines in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    st = pipe._last_state
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    np.savez_compressed(
        opts.out, line_counts=np.array([len(p) for p in pred]),
        lines=np.concatenate(pred).astype(np.float32),
        neighbor_ids=np.asarray(st["neighbor_ids"], np.int16))
    print(f"wrote {opts.out} ({os.path.getsize(opts.out)} bytes; "
          f"{len(pred)} lines) in {time.perf_counter() - t_all:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
