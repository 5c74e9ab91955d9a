"""Write the JAX package's answer on the full-resolution facade.

    JAX_PLATFORMS=cpu python tests/make_torch_lsd_reference.py \
        [--width 3072 --height 2304 --ss 1 --views 10 --neighbors 6] \
        [--rescue] [--out tests/data/...npz]

Renders the first ``--views`` views of the synthetic facade
(``line3dpp_tpu_torch.utils.synthetic``, ``--ss`` x ``--ss`` supersampling)
at the given size, detects segments in each with the JAX package on the
CPU, reconstructs with JAX ``Line3D(Config(optimize=False,
num_neighbors=--neighbors))`` and writes to the npz:
the image digests, the segments of every view, the 3D lines, and count_f1,
recall and precision against the 74 ground-truth lines at 1% scene scale.
``--rescue`` detects with the rescue cascade (``rescue=True``) and
reconstructs with ``Config(lsd_rescue=True)`` and its default
``optimize=True`` (bundled lines); it also writes the number of rescued
rectangles of every view (``n_rescue``) and their segments
(``rescued_segments``, the views one after another), and defaults ``--out``
to ``tests/data/torch_scene2_<width>_rescue_jax_reference.npz``.
``chip_smoke.py`` holds the port's detections and lines on the card against
the default file (3072 x 2304, 10 views); ``tests/test_torch_lsd_scene.py``
holds the port's CPU run against the 1024 x 768 one, written with
``--width 1024 --height 768 --ss 2 --views 4 --neighbors 3 --out
tests/data/torch_scene2_1024_jax_reference.npz``.  Not collected by pytest
(its name does not start with test_).

``--path pallas`` (the default) detects as the JAX package does on a TPU,
which is what the port follows: ``ops.lsd._lsd_core(use_pallas_cc=True,
use_pallas_gather=False)``, with the Pallas kernels in interpret mode as
the JAX package's own tests run them, and every capacity of that path
checked.  ``--path xla`` runs ``ops.lsd.detect`` as it runs on a CPU: its
connected components stop after a fixed 16 iterations of label
propagation, which does not converge on the facade's window frames, so its
segments are a different function of the image.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEFAULT_OUT = os.path.join(REPO, "tests", "data",
                           "torch_scene2_3072_jax_reference.npz")


def pallas_detect(img: np.ndarray, rescue: bool = False):
    """The JAX package's TPU detection path on the CPU (interpret-mode
    kernels, per-pixel label gather), with its capacities checked.
    Returns the segments, the number of rescued rectangles and their
    segments: the accepted components of each round that fail one of the
    plain size, density and NFA tests."""
    import jax.numpy as jnp
    from line3dpp_tpu.ops import lsd, lsd_cc, lsd_fit

    saved = [(lsd_cc, "cc_tiles")] + [
        (lsd_fit, n) for n in ("moments", "gate_moments", "gate_pixels",
                               "extents", "band_counts")]
    orig = [getattr(m, n) for m, n in saved]
    for (m, n), fn in zip(saved, orig):
        setattr(m, n, functools.partial(fn, interpret=True))
    lsd._lsd_round.clear_cache()
    lsd_round, rescued = lsd._lsd_round, []

    def recording_round(*args, **kwargs):
        out = lsd_round(*args, **kwargs)
        segs_r, ok_r, d_r = np.asarray(out[0]), np.asarray(out[1]), out[3]
        plain = ((np.asarray(d_r["npix"]) >= 5.0)
                 & (np.asarray(d_r["density"]) >= lsd.DENSITY_TH)
                 & (np.asarray(d_r["log_nfa"]) > lsd.LOG_EPS))
        rescued.append(segs_r[ok_r & ~plain])
        return out

    lsd._lsd_round = recording_round
    try:
        H, W = img.shape
        segs, ok, d = lsd._lsd_core(jnp.asarray(img, jnp.float32), H, W,
                                    use_pallas_cc=True,
                                    use_pallas_gather=False, rescue=rescue)
        segs, ok = np.asarray(segs), np.asarray(ok)
    finally:
        lsd._lsd_round = lsd_round
        for (m, n), fn in zip(saved, orig):
            setattr(m, n, fn)
        lsd._lsd_round.clear_cache()
    caps = [(int(d["cc_unconverged"]), 0), (int(d["link_count"]),
                                            int(d["link_cap"])),
            (int(d["used_count"]), int(d["nc_cap"])),
            (int(d["n_alive"]), int(d["nc2_cap"])),
            (int(d["n_alive2"]), int(d["nc3_cap"])),
            (int(d["ncomp"]), int(d["c_cap"]))]
    if any(got > cap for got, cap in caps):
        raise RuntimeError(f"a capacity of the JAX Pallas path overflowed: "
                           f"{caps}")
    rescued = np.concatenate(rescued).astype(np.float64)
    if len(rescued) != int(d["n_rescue"]):
        raise RuntimeError(f"{len(rescued)} accepted components fail a plain "
                           f"test, the detector counts {int(d['n_rescue'])} "
                           f"rescued")
    return segs[ok].astype(np.float64), len(rescued), rescued


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=3072)
    ap.add_argument("--height", type=int, default=2304)
    ap.add_argument("--ss", type=int, default=1)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--neighbors", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rescue", action="store_true")
    ap.add_argument("--path", choices=("pallas", "xla"), default="pallas")
    opts = ap.parse_args()
    if opts.out is None:
        opts.out = DEFAULT_OUT if not opts.rescue else os.path.join(
            REPO, "tests", "data",
            f"torch_scene2_{opts.width}_rescue_jax_reference.npz")

    import jax

    jax.config.update("jax_platforms", "cpu")
    import line3dpp_tpu as l3d
    from line3dpp_tpu.ops import lsd
    from line3dpp_tpu.utils.golden import (line_match_metrics, scene_scale,
                                           segment_set_metrics)
    from line3dpp_tpu_torch.utils import synthetic

    t_all = time.perf_counter()
    quads, gt = synthetic.build_scene()
    cams = synthetic.make_cameras(10, width=opts.width,
                                  height=opts.height)[:opts.views]
    t0 = time.perf_counter()
    images = [synthetic.render(c, quads, seed=100 + i, ss=opts.ss)
              for i, c in enumerate(cams)]
    print(f"rendered {len(images)} views at {opts.width}x{opts.height} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    if opts.path == "pallas":
        detect = functools.partial(pallas_detect, rescue=opts.rescue)
    else:
        detect = lambda im: (lsd.detect(im, rescue=opts.rescue), -1,
                             np.zeros((0, 4)))
    segs, n_rescue, rescued = [], [], []
    for i, img in enumerate(images):
        t0 = time.perf_counter()
        s, nr, rs = detect(img)
        segs.append(s)
        n_rescue.append(nr)
        rescued.append(rs)
        print(f"view {i}: {len(s)} segments, {nr} rescued, in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cfg = (l3d.Config(lsd_rescue=True, num_neighbors=opts.neighbors)
           if opts.rescue else
           l3d.Config(optimize=False, num_neighbors=opts.neighbors))
    pipe = l3d.Line3D(cfg)
    for i, (c, s) in enumerate(zip(cams, segs)):
        pipe.add_view(i, l3d.Camera(c.K, c.R, c.t, c.width, c.height), s)
    pipe.match_images()
    lines = pipe.reconstruct_3d_lines()
    print(f"Line3D: {len(lines)} lines in {time.perf_counter() - t0:.1f} s",
          flush=True)

    tol = 0.01 * scene_scale(gt)
    pred = [l.segments3d for l in lines]
    sm = segment_set_metrics(np.concatenate(pred) if pred
                             else np.zeros((0, 6)), gt, tol)
    lm = line_match_metrics(pred, [gt[i:i + 1] for i in range(len(gt))], tol)
    print(f"vs {len(gt)} GT lines: count_f1 {lm['count_f1']:.5f} recall "
          f"{sm['recall']:.5f} precision {sm['precision']:.5f}", flush=True)

    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    np.savez_compressed(
        opts.out, width=opts.width, height=opts.height, ss=opts.ss,
        neighbors=opts.neighbors,
        digests=np.array([synthetic.image_digest(im) for im in images]),
        seg_counts=np.array([len(s) for s in segs]),
        n_rescue=np.array(n_rescue), optimize=bool(cfg.optimize),
        rescued_segments=np.concatenate(rescued),
        segments=np.concatenate(segs).astype(np.float64),
        line_counts=np.array([len(p) for p in pred]),
        lines=(np.concatenate(pred) if pred else np.zeros((0, 6))),
        count_f1=lm["count_f1"], recall=sm["recall"],
        precision=sm["precision"])
    print(f"wrote {opts.out} ({os.path.getsize(opts.out)} bytes) in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
