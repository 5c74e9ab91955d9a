"""Write the JAX package's bundled result on the 26 cached views.

    JAX_PLATFORMS=cpu python tests/make_torch_bundling_reference.py \
        [--out tests/data/torch_bundling_26_jax_reference.npz]

Runs JAX ``Line3D(Config())`` (every option at its default: ``optimize``
on, 250 Levenberg-Marquardt iterations) on the 26 bundled views from their
cached segments, on the CPU, and writes to the npz

* the Levenberg-Marquardt problem the JAX package assembled
  (``optimize_cluster_lines(_capture=...)``), without its power-of-two
  padding: ``params0`` (C, 4), ``obs_cluster`` (O,), the observed endpoints
  ``p1`` and ``p2`` (O, 2) and directions ``d2`` (O, 2), and the cameras as
  a table of distinct rows ``cam_rows`` (n, 21) = (K^-T, R, t) with each
  observation's row ``obs_cam`` (O,);
* JAX's answer: the optimized ``params`` (C, 4) and the per-cluster robust
  cost before (``cost0``) and after (``cost``) the 250 iterations;
* the final 3D lines (``line_counts``, ``lines``).

``chip_smoke.py`` holds the port against this file on the card: its
``lm_reference`` turns the stored arrays back into the arguments of
``line3dpp_tpu_torch.ops.bundling.lm_optimize``.  Not collected by pytest
(its name does not start with test_).
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
                           "torch_bundling_26_jax_reference.npz")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    opts = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import line3dpp_tpu as l3d
    from line3dpp_tpu.ops import bundling
    from line3dpp_tpu_torch.utils.testdata import load_views

    cap: dict = {}
    orig = bundling.optimize_cluster_lines

    def capturing(*args, **kw):
        return orig(*args, _capture=cap, **kw)

    t_all = time.perf_counter()
    pipe = l3d.Line3D(l3d.Config())
    for v in load_views():
        pipe.add_view(v.cam_id, l3d.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    t0 = time.perf_counter()
    pipe.match_images()
    print(f"match_images: {time.perf_counter() - t0:.1f} s", flush=True)
    bundling.optimize_cluster_lines = capturing
    try:
        t0 = time.perf_counter()
        lines = pipe.reconstruct_3d_lines()
    finally:
        bundling.optimize_cluster_lines = orig
    print(f"reconstruct_3d_lines: {len(lines)} lines in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # JAX's parameters and costs on the problem exactly as it solved it
    C, Cpad = int(cap["C"]), int(cap["Cpad"])
    names = ("obs_cluster", "Ko", "Ro", "to", "p1h", "p2h", "d2")
    args = [jnp.asarray(cap[n]) for n in names]
    iters = int(pipe.config.max_iter_optim)
    params = bundling.lm_optimize(jnp.asarray(cap["params0"]), *args,
                                  num_clusters=Cpad, iterations=iters)
    cost0 = np.asarray(bundling.lm_cost(jnp.asarray(cap["params0"]), *args,
                                        num_clusters=Cpad))[:C]
    cost = np.asarray(bundling.lm_cost(params, *args, num_clusters=Cpad))[:C]
    print(f"LM: {C} clusters, {iters} iterations, total cost "
          f"{cost0.sum():.2f} -> {cost.sum():.2f}", flush=True)

    real = np.asarray(cap["obs_cluster"]) < C
    cam = np.concatenate([cap["Ko"].reshape(-1, 9), cap["Ro"].reshape(-1, 9),
                          cap["to"]], axis=1)[real].astype(np.float32)
    cam_rows, obs_cam = np.unique(cam, axis=0, return_inverse=True)
    pred = [l.segments3d for l in lines]
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    np.savez_compressed(
        opts.out, iterations=iters,
        params0=np.asarray(cap["params0"], np.float32)[:C],
        obs_cluster=np.asarray(cap["obs_cluster"], np.int32)[real],
        cam_rows=cam_rows, obs_cam=obs_cam.reshape(-1).astype(np.int16),
        p1=cap["p1h"][real, :2].astype(np.float32),
        p2=cap["p2h"][real, :2].astype(np.float32),
        d2=cap["d2"][real].astype(np.float32),
        params=np.asarray(params, np.float32)[:C],
        cost0=cost0.astype(np.float32), cost=cost.astype(np.float32),
        line_counts=np.array([len(p) for p in pred]),
        lines=np.concatenate(pred).astype(np.float32))
    print(f"wrote {opts.out} ({os.path.getsize(opts.out)} bytes; {C} "
          f"clusters, {int(real.sum())} observations, {len(cam_rows)} camera "
          f"rows) in {time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
