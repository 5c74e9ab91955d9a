"""How far the port's facade detections and lines move with the order of
the rectangle-fit moment sums.

    python tests/measure_torch_lsd_facade.py [--views 0 1 ...] \
        [--ref tests/data/torch_scene2_3072_jax_reference.npz] \
        [--shuffles 5] [--threads 4]

Renders the reference's views (``line3dpp_tpu_torch.utils.synthetic``) and
runs the port's detector on the CPU once per summation order of the
float32 moment terms (kernels K7/K8 and their plain versions):

* ``f64``: as shipped, the terms summed in float64 (as the card sums them);
* ``f32``: the same terms summed in float32 in list order (``index_add_``);
* ``f32-sN``: summed in float32 in the order of a random permutation of
  the pixel list, drawn from seed N (``--shuffles`` of them).

All are equally valid float32 evaluations of the same sums; the JAX
package's interpret-mode kernels sum them in float32 one-hot products, one
more such order.  The ``f64`` run also repeats every border merge with 64
iterations instead of the fixed 8 and counts the pixels whose merged label
differs (0: the 8 iterations converged), and counts the components whose
log10 NFA lies within 0.01 of the acceptance threshold 0 (the float32
betainc of the JAX package is up to 0.0094 off in log10,
``tests/test_torch_lsd.py``, so only these can flip with it).

Prints, per view, each order's segment count and mutual 1-px endpoint
coverage against the JAX reference's detections
(``tests/make_torch_lsd_reference.py``) and against ``f64``.  When every
view ran, it reconstructs 3D lines from each detection set and from JAX's
with the port's ``Line3D`` on the CPU (the reference's configuration), and
prints each set's line count, its count_f1 against the reference's JAX
lines, and count_f1, recall and precision against the ground-truth lines;
then, over the orders, the worst of each quantity that the facade checks
of ``chip_smoke.py`` and ``tests/test_torch_lsd_scene.py`` bound.  Imports
no JAX.  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEFAULT_REF = os.path.join(REPO, "tests", "data",
                           "torch_scene2_3072_jax_reference.npz")


def moments_f32(seed):
    """A stand-in for ``lsd_fit.moments_plain`` that sums the float32
    moment terms in float32: in list order, or in the order of a random
    permutation drawn from ``seed``."""
    import torch
    from line3dpp_tpu_torch.ops import lsd_fit

    def moments(slot, xs, ys, mag, pix, C):
        terms = lsd_fit._moment_terms(xs, ys, mag, pix)
        key = slot.long()
        if seed is not None:
            perm = torch.randperm(key.numel(), generator=torch.Generator(
                ).manual_seed(seed))
            key, terms = key[perm], terms[perm]
        acc = torch.zeros((C + 1, 7), dtype=torch.float32)
        acc.index_add_(0, key, terms)     # sequential on the CPU
        out = torch.zeros((C, lsd_fit.TABLE_COLS), dtype=torch.float32)
        out[:, :7] = acc[:C]
        return out
    return moments


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", default=DEFAULT_REF)
    ap.add_argument("--views", type=int, nargs="*")
    ap.add_argument("--shuffles", type=int, default=5,
                    help="number of random float32 summation orders")
    ap.add_argument("--threads", type=int, default=4,
                    help="torch intra-op threads")
    opts = ap.parse_args()

    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import lsd, lsd_cc, lsd_fit
    from line3dpp_tpu_torch.utils import golden, synthetic

    torch.set_num_threads(opts.threads)

    orders = {"f64": lsd_fit.moments_plain, "f32": moments_f32(None)}
    for s in range(opts.shuffles):
        orders[f"f32-s{s}"] = moments_f32(s)

    merge = lsd_cc.merge_tile_labels
    unmerged = []

    def merge_checked(lab, angle, active, tol, tile, iters=8):
        T, n_links = merge(lab, angle, active, tol, tile, iters=iters)
        T64, _ = merge(lab, angle, active, tol, tile, iters=64)
        valid = lab.reshape(-1)[active.reshape(-1)].long()
        unmerged.append(int((T[valid] != T64[valid]).sum()))
        return T, n_links

    nfa = lsd._nfa
    near = []

    def nfa_checked(*args, **kwargs):
        out = nfa(*args, **kwargs)
        near.append(int((out.abs() <= 0.01).sum()))
        return out

    with np.load(opts.ref) as data:
        ref = {k: data[k] for k in data.files}
    W, H, ss = int(ref["width"]), int(ref["height"]), int(ref["ss"])
    ref_segs = np.split(ref["segments"], np.cumsum(ref["seg_counts"])[:-1])
    ref_lines = np.split(ref["lines"], np.cumsum(ref["line_counts"])[:-1])
    views = opts.views if opts.views else range(len(ref_segs))
    quads, gt = synthetic.build_scene()
    cams = synthetic.make_cameras(10, width=W, height=H)
    sets = {name: [] for name in orders}
    # per order: [covered, n] against JAX, worst per-view coverage, worst
    # relative count difference
    vs_jax = {name: [0.0, 0, 1.0, 0.0] for name in orders}
    shipped = lsd_fit.moments_plain
    t_start = time.perf_counter()
    for v in views:
        img = synthetic.render(cams[v], quads, seed=100 + v, ss=ss)
        t0 = time.perf_counter()
        unmerged.clear()
        near.clear()
        for name, fn in orders.items():
            checks = name == "f64"
            if checks:
                lsd_cc.merge_tile_labels, lsd._nfa = merge_checked, nfa_checked
            lsd_fit.moments_plain = fn
            try:
                sets[name].append(lsd.detect(img, device="cpu"))
            finally:
                lsd_cc.merge_tile_labels, lsd._nfa = merge, nfa
                lsd_fit.moments_plain = shipped
        parts = []
        for name in orders:
            segs = sets[name][-1]
            cov, n_cov, n = golden.mutual_coverage(segs, ref_segs[v])
            own = golden.mutual_coverage(segs, sets["f64"][-1])[0]
            acc = vs_jax[name]
            acc[0] += n_cov
            acc[1] += n
            acc[2] = min(acc[2], cov)
            acc[3] = max(acc[3], abs(len(segs) - len(ref_segs[v]))
                         / len(ref_segs[v]))
            parts.append(f"{name} {len(segs)} ({cov:.4f} / {own:.4f})")
        print(f"view {v}: JAX {len(ref_segs[v])} segments; per order: "
              f"segments (coverage against JAX / against f64): "
              + ", ".join(parts)
              + f"; pixels whose 8-iteration merge differs from 64 "
              f"iterations, per round: {unmerged}; components with "
              f"|log10 NFA| <= 0.01: {sum(near)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"{W}x{H}, views {list(views)}, coverage against JAX over all "
          f"views: " + ", ".join(f"{name} {a[0] / max(a[1], 1):.4f}"
                                 for name, a in vs_jax.items()), flush=True)
    if len(sets["f64"]) != len(ref_segs):
        return

    tol = 0.01 * golden.scene_scale(gt)
    gt_lines = [gt[i:i + 1] for i in range(len(gt))]
    sets["JAX"] = ref_segs
    results = {}
    for name, seg_lists in sets.items():
        pipe = lt.Line3D(lt.Config(optimize=False,
                                   num_neighbors=int(ref["neighbors"])),
                         device="cpu")
        for i, (c, segs) in enumerate(zip(cams, seg_lists)):
            pipe.add_view(i, c, segs)
        pipe.match_images()
        pred = [l.segments3d for l in pipe.reconstruct_3d_lines()]
        sm = golden.segment_set_metrics(np.concatenate(pred), gt, tol)
        r = dict(lines=len(pred),
                 f1_jax=golden.line_match_metrics(pred, ref_lines,
                                                  tol)["count_f1"],
                 count_f1=golden.line_match_metrics(pred, gt_lines,
                                                    tol)["count_f1"],
                 recall=sm["recall"], precision=sm["precision"])
        results[name] = r
        print(f"lines from the {name} detections: {r['lines']} lines, "
              f"count_f1 against JAX's {len(ref_lines)} lines "
              f"{r['f1_jax']:.4f}; against the {len(gt)} GT lines count_f1 "
              f"{r['count_f1']:.4f} recall {r['recall']:.4f} precision "
              f"{r['precision']:.4f}", flush=True)

    want = {k: float(ref[k]) for k in ("count_f1", "recall", "precision")}
    print(f"worst over the {len(orders)} orders, against JAX: per-view "
          f"coverage {min(a[2] for a in vs_jax.values()):.4f}, coverage "
          f"over all views {min(a[0] / a[1] for a in vs_jax.values()):.4f},"
          f" per-view count difference "
          f"{max(a[3] for a in vs_jax.values()):.4f}; line count difference "
          f"{max(abs(results[n]['lines'] - len(ref_lines)) for n in orders)}"
          f", count_f1 against JAX's lines "
          f"{min(results[n]['f1_jax'] for n in orders):.4f}; GT metrics "
          f"below JAX's reference values by at most " + ", ".join(
              f"{k} {max(want[k] - results[n][k] for n in orders):.4f}"
              for k in want) + f" (reference {want})", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
