#!/usr/bin/env python3
"""The collinearity stage's square roots on one GPU: the float64 route of
``ops/collinearity._sqrt`` (float32 in, float64 ``sqrt``, rounded back)
against torch's float32 ``sqrt``.

    python tests/measure_torch_collinearity_sqrt.py [--out DIR] [--calls 5]

- Every non-negative finite float32 (2^31 - 2^23 values, in chunks): how
  many square roots differ in their bits between the two routes.
- The 26 cached views under the reference's options (``perform_rdd``,
  ``collinearity_t=2``, as ``tests/data/torch_features_jax_reference.npz``
  stores them): ``collinear_edges`` is captured from one pipeline run and
  then run with each route on the same inputs; per batch of views the pair
  masks, the edge masks and the weight planes are compared bit for bit,
  and the compacted edges too.
- The card's time of ``collinear_edges`` with each route, in turns
  (float64, float32, float32, float64): kernels, copies and memsets summed
  over ``--calls`` calls (torch.profiler), and the wall time per call.

Prints the card's name and power limit and one JSON line, also written to
``--out``/collinearity_sqrt.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CHUNK = 1 << 27


def sqrt32(x):
    import torch

    return torch.sqrt(x)


def exhaustive_differences(dev) -> int:
    """Non-negative finite float32 values whose square root differs in its
    bits between the float64 route and torch's float32 ``sqrt``."""
    import torch
    from line3dpp_tpu_torch.ops import collinearity

    top = 0x7F800000                  # +inf's bits: every finite value below
    diff = 0
    for lo in range(0, top, CHUNK):
        bits = torch.arange(lo, min(lo + CHUNK, top), dtype=torch.int32,
                            device=dev)
        x = bits.view(torch.float32)
        diff += int((collinearity._sqrt(x).view(torch.int32)
                     != sqrt32(x).view(torch.int32)).sum())
    return diff


def captured_inputs(dev):
    """The arguments the pipeline passes to ``collinear_edges`` on the 26
    cached views under the reference's options."""
    import numpy as np
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import collinearity
    from line3dpp_tpu_torch.utils.testdata import load_views

    with np.load(chip_smoke.FEATURES_NPZ) as data:
        ids = [int(i) for i in data["reference_views"]]
        kw = json.loads(str(data["reference_config"]))
    calls = []
    orig = collinearity.collinear_edges

    def wrapped(*args, **fkw):
        calls.append((args, fkw))
        return orig(*args, **fkw)

    collinearity.collinear_edges = wrapped
    try:
        pipe = lt.Line3D(lt.Config(**kw), device=dev)
        for v in load_views(ids):
            pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width,
                                              v.height), v.segments)
        pipe.match_images()
        pipe.reconstruct_3d_lines()
    finally:
        collinearity.collinear_edges = orig
    chip_smoke.check(len(calls) == 1, "collinear_edges was not called once")
    return calls[0], kw, len(ids)


def with_sqrt(fn, route):
    """``fn()`` with ``collinearity._sqrt`` set to ``route``."""
    from line3dpp_tpu_torch.ops import collinearity

    orig = collinearity._sqrt
    collinearity._sqrt = route
    try:
        return fn()
    finally:
        collinearity._sqrt = orig


def plane_differences(args) -> dict:
    """Elements of the pair masks, edge masks and weight planes that differ
    in their bits between the two routes, over every batch of views."""
    import torch
    from line3dpp_tpu_torch.ops import collinearity as c

    (segs, mask, P1, P2, d1, d2, valid, k_reg, med, med_scene, t_px,
     min_aff) = args
    V, S = mask.shape
    batch = max(1, c._BATCH_BYTES // (c._PLANES * 4 * S * S))
    out = dict(pairs=V * S * S, collin=0, edge=0, weight=0, batch=batch)
    for lo in range(0, V, batch):
        sl = slice(lo, min(lo + batch, V))

        def run():
            col = c.collinear_pairs(segs[sl], mask[sl], t_px)
            w, e = c.collinear_similarity(
                P1[sl], P2[sl], d1[sl], d2[sl], valid[sl], col, k_reg[sl],
                med[sl], med_scene, min_aff)
            return col, w, e
        c64, w64, e64 = run()
        c32, w32, e32 = with_sqrt(run, sqrt32)
        out["collin"] += int((c64 != c32).sum())
        out["edge"] += int((e64 != e32).sum())
        out["weight"] += int((w64.view(torch.int32)
                              != w32.view(torch.int32)).sum())
        del c64, w64, e64, c32, w32, e32
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--calls", type=int, default=5)
    opts = ap.parse_args()

    import numpy as np
    import torch
    from line3dpp_tpu_torch.ops import collinearity

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)

    t0 = time.perf_counter()
    res = {"card": card.strip(),
           "exhaustive_differences": exhaustive_differences(dev)}
    res["exhaustive_s"] = time.perf_counter() - t0
    (args, fkw), kw, views = captured_inputs(dev)
    res.update(config=kw, views=views, planes=plane_differences(args))

    e64 = collinearity.collinear_edges(*args, **fkw)
    e32 = with_sqrt(lambda: collinearity.collinear_edges(*args, **fkw),
                    sqrt32)
    res["edges"] = int(len(e64[0]))
    res["edges_equal"] = bool(
        all(np.array_equal(a, b) for a, b in zip(e64[:3], e32[:3]))
        and np.array_equal(e64[3].view(np.int32), e32[3].view(np.int32)))

    routes = {"float64": collinearity._sqrt, "float32": sqrt32}
    turns = {"float64": [], "float32": []}
    for name in ("float64", "float32", "float32", "float64"):
        def call(route=routes[name]):
            return with_sqrt(
                lambda: collinearity.collinear_edges(*args, **fkw), route)
        dev_ms = chip_smoke.device_sum_ms(call, calls=opts.calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(opts.calls):
            call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / opts.calls
        turns[name].append(dict(device_ms=dev_ms, wall_ms=wall_ms))
    res["turns"] = turns
    line = json.dumps(res)
    print(line, flush=True)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "collinearity_sqrt.json"), "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
