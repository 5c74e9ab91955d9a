"""Write the JAX package's lines for the eight configurations of the
facade sweeps, from JAX's own facade detections.

    JAX_PLATFORMS=cpu python tests/make_torch_scene2_sweep_reference.py \
        [--out tests/data/torch_scene2_sweep_jax_reference.npz]

The detections are the ``segments`` and ``seg_counts`` of
``tests/data/torch_scene2_3072_jax_reference.npz`` (the JAX package's
detection of the 10 facade views at 3072 x 2304,
``tests/make_torch_lsd_reference.py``).  JAX's ``Line3D`` takes them
through ``add_view`` on the CPU under each configuration of the port's
sweeps, the options taken from the port's drivers so that both packages
run the same ``Config``:

* ``split_<t>_<sym>``: ``tools.validate_scene2.CONFIGS``
  (``split_bimodal_t`` in {0.0, 1.1} x ``match_symmetrization`` in
  {ordered, full}, ``num_neighbors=6``, ``optimize=False``);
* ``anchor_<a>``: ``tools.validate_scene2_anchor.ANCHORS``
  (``cluster_strong_min`` in {0, 1, 2, 3}, ``num_neighbors=6``, line
  bundling on).

The npz holds ``detections`` (the SHA-256 of the segments' bytes) and,
per configuration ``name``, ``name_config`` (the options as JSON),
``name_line_counts`` and ``name_lines``.  Took 177 s on the CPU (peak 2.8
GB resident).  ``chip_smoke.py`` holds the port on the card against this
file, and ``tests/test_torch_drivers.py`` on the CPU.  Not collected by
pytest (its name does not start with test_).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DETECTIONS = os.path.join(REPO, "tests", "data",
                          "torch_scene2_3072_jax_reference.npz")
DEFAULT_OUT = os.path.join(REPO, "tests", "data",
                           "torch_scene2_sweep_jax_reference.npz")


def sweep_options() -> dict:
    """name -> Config options of the eight configurations."""
    from line3dpp_tpu_torch.tools import (validate_scene2,
                                          validate_scene2_anchor)

    out = {f"split_{t}_{sym}": validate_scene2.options(t, sym)
           for t, sym in validate_scene2.CONFIGS}
    out.update({f"anchor_{a}": validate_scene2_anchor.options(a)
                for a in validate_scene2_anchor.ANCHORS})
    return out


def detections() -> tuple[list, int, int, str]:
    """JAX's facade detections: the per-view segments, the image size and
    the digest of the segments."""
    with np.load(DETECTIONS) as data:
        segs, counts = data["segments"], data["seg_counts"]
        W, H = int(data["width"]), int(data["height"])
    digest = hashlib.sha256(np.ascontiguousarray(segs).tobytes()).hexdigest()
    return np.split(segs, np.cumsum(counts)[:-1]), W, H, digest


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    opts = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import line3dpp_tpu as l3d
    from line3dpp_tpu_torch.utils import synthetic

    segs, W, H, digest = detections()
    cams = synthetic.make_cameras(len(segs), width=W, height=H)
    t_all = time.perf_counter()
    out = {"detections": digest}
    for name, kw in sweep_options().items():
        t0 = time.perf_counter()
        pipe = l3d.Line3D(l3d.Config(**kw))
        for i, (c, s) in enumerate(zip(cams, segs)):
            pipe.add_view(i, l3d.Camera(c.K, c.R, c.t, c.width, c.height), s)
        pipe.match_images()
        pred = [l.segments3d for l in pipe.reconstruct_3d_lines()]
        print(f"{name}: {len(pred)} lines in {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
        out.update({
            f"{name}_config": json.dumps(kw),
            f"{name}_line_counts": np.array([len(p) for p in pred]),
            f"{name}_lines": np.concatenate(pred).astype(np.float32)})
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    np.savez_compressed(opts.out, **out)
    print(f"wrote {opts.out} ({os.path.getsize(opts.out)} bytes) in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
