"""Write the JAX package's lines under the optional reconstruction stages
on the bundled views.

    JAX_PLATFORMS=cpu python tests/make_torch_features_reference.py \
        [--out tests/data/torch_features_jax_reference.npz]

Two configurations, each run by JAX's ``Line3D`` on the 26 bundled views
from their cached segments (``testdata/L3D_cache/``) on the CPU, at the
defaults but ``optimize=False`` (``FEATURES`` below):

* ``reference`` — the reference's own options as the CLI's ``-d -r 2``
  sets them: ``perform_rdd=True, collinearity_t=2.0``;
* ``compensations`` — the repository's own compensations:
  ``split_bimodal_t=1.1, split_strong_min=3.0, cluster_strong_min=3.0,
  match_rel_cut=0.5``.

The npz holds, per configuration ``name``, ``name_views`` (the camera
ids), ``name_config`` (the options as JSON), ``name_line_counts`` and
``name_lines``.  Took 194 s on an 8-core CPU (peak 8.8 GB resident: JAX's
collinearity holds the (26, 3000, 3000) grid) and stores 1,685 and 2,436
lines in 104 KB.  ``chip_smoke.py`` holds the port against
this file on the card.  Not collected by pytest (its name does not start
with test_).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEFAULT_OUT = os.path.join(REPO, "tests", "data",
                           "torch_features_jax_reference.npz")
# name -> (camera ids, Config options)
FEATURES = {
    "reference": (list(range(26)), dict(
        optimize=False, perform_rdd=True, collinearity_t=2.0)),
    "compensations": (list(range(26)), dict(
        optimize=False, split_bimodal_t=1.1, split_strong_min=3.0,
        cluster_strong_min=3.0, match_rel_cut=0.5)),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--only", nargs="*", default=list(FEATURES))
    opts = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import line3dpp_tpu as l3d
    from line3dpp_tpu_torch.utils.testdata import load_views

    t_all = time.perf_counter()
    out = {}
    for name in opts.only:
        ids, kw = FEATURES[name]
        pipe = l3d.Line3D(l3d.Config(**kw))
        for v in load_views(ids):
            pipe.add_view(v.cam_id,
                          l3d.Camera(v.K, v.R, v.t, v.width, v.height),
                          v.segments)
        t0 = time.perf_counter()
        pipe.match_images()
        pred = [l.segments3d for l in pipe.reconstruct_3d_lines()]
        print(f"{name}: {len(pred)} lines in {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
        out.update({
            f"{name}_views": np.array(ids), f"{name}_config": json.dumps(kw),
            f"{name}_line_counts": np.array([len(p) for p in pred]),
            f"{name}_lines": np.concatenate(pred).astype(np.float32)})
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    np.savez_compressed(opts.out, **out)
    print(f"wrote {opts.out} ({os.path.getsize(opts.out)} bytes) in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
