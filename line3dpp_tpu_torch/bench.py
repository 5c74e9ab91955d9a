"""Benchmark of the port: the device step's throughput on a synthetic
workload, and the timed body of a cold images -> lines pass.

    python -m line3dpp_tpu_torch.bench [--cpu]

The port's counterpart of the repository's ``bench.py``.  ``main`` runs
the device-step metric, which is what ``bench.py`` measures when the
testdata photos are absent: ``models/step.forward_step`` (epipolar
matching, scoring, filtering, affinity) on ``make_workload``'s 26 views x
3000 segments x 10 neighbours at k = 10, inputs on the card before the
clock starts, one warm-up run (which builds the kernels), then ``RUNS``
(3) timed runs, each ending when the card has finished it.  It prints each
run's time, the median, the peak device memory, the K1/K2/K3 launches of
a run and the card's name and power limit, and as its last line one JSON
object with ``bench.py``'s keys: ``metric`` (``device_step_images_per_sec``
= views / best run), ``value``, ``unit`` and ``vs_baseline`` (the value
over ``BASELINE_IMAGES_PER_SEC``, the median of the port's first three
measurements on the card; null at other sizes).  On the CPU (``--cpu``)
the kernels' plain versions run, the unit says so and ``vs_baseline`` is
null.
``images_e2e`` is the timed body of ``bench.py``'s cold pass over images
held in memory.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .camera import (Camera, CameraBatch, fundamental_matrix,
                     median_center_translation, rotation_from_rpy)
from .config import Config
from .models.pipeline import Line3D
from .models.step import forward_step
from .ops import kernels
from .tools import card_line, device_for, synchronize

# device_step_images_per_sec on the card: the median of the port's first
# three measurements, on one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, torch 2.11.0+cu128, in chip calls 17 and 18 (PERF.md section 5):
# 1826.587 from chip_smoke.py in call 17, 1962.468 from chip_smoke.py and
# 1977.461 from this module's main in call 18.  The three spread over 8%
# with no change of code, so a vs_baseline within 0.93-1.01 is noise, not
# a gain.
BASELINE_IMAGES_PER_SEC = 1962.468
# timed runs of the device step, after the warm-up run
RUNS = 3
# bench.py's static arguments of forward_step
STEP_OPTIONS = dict(
    epipolar_overlap=0.25, knn=10, two_sig_a_sqr=200.0, min_similarity=0.5,
    check_orientation=True, min_best_score=0.75, min_best_score_perc=0.10,
    min_affinity=0.5, pair_chunk=8)
# the kernels of the step: K1, K2 and K3
STEP_KERNELS = ("match_pairs", "score_matches", "gather_target_estimates")


def make_workload(V=26, S=3000, N=10, seed=0):
    """``bench.py``'s synthetic step inputs: 800 random 3D segments seen by
    ``V`` cameras of 3072 x 2304 on a line, each view filled up to ``S``
    segments with random 2D clutter, the ``N`` nearest views as
    neighbours.  Returns the eight arrays of ``forward_step`` (segments,
    mask, RtKinv, C, k_reg, neighbour ids, F, pair validity), equal bit
    for bit to ``bench.make_workload``'s from the same seed.  Below 800
    segments (where ``bench.make_workload`` raises) a view keeps the
    first ``S`` projections and no clutter, which sizes the CPU runs of
    ``tools/bench_scaling.py``."""
    rng = np.random.default_rng(seed)
    n_lines = 800
    P = rng.uniform([-4, -3, 8], [4, 3, 16], size=(n_lines, 3))
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.5, 2.0, size=(n_lines, 1))

    K = np.array([[2400.0, 0, 1536], [0, 2400.0, 1152], [0, 0, 1]])
    cams = []
    for i in range(V):
        R = rotation_from_rpy(rng.normal() * 0.03, -0.02 * i + 0.2,
                              rng.normal() * 0.03)
        C = np.array([0.35 * i - 4.5, rng.normal() * 0.1, rng.normal() * 0.1])
        cams.append(Camera(K, R, -R @ C, 3072, 2304))

    segs = np.zeros((V, S, 4), np.float32)
    mask = np.zeros((V, S), bool)
    for i, cam in enumerate(cams):
        sv = np.hstack([cam.project(P), cam.project(Q)]).astype(np.float32)
        # fill the remaining slots with clutter segments (a full load)
        n_fill = max(S - len(sv), 0)
        a = rng.uniform([0, 0], [3072, 2304], size=(n_fill, 2))
        ang = rng.uniform(0, 2 * np.pi, n_fill)
        ln = rng.uniform(20, 300, n_fill)
        b = a + np.stack([np.cos(ang), np.sin(ang)], -1) * ln[:, None]
        segs[i] = np.vstack([sv, np.hstack([a, b])])[:S]
        mask[i] = True

    translation = median_center_translation(cams)
    cb = CameraBatch.from_cameras(cams, sigma_p=2.5, translation=translation)
    centered = [Camera(c.K, c.R, -c.R @ (c.C - translation),
                       c.width, c.height) for c in cams]

    neighbor_ids = np.zeros((V, N), np.int32)
    pair_valid = np.zeros((V, N), bool)
    F = np.zeros((V, N, 3, 3), np.float32)
    for i in range(V):
        nbrs = sorted((j for j in range(V) if j != i),
                      key=lambda j: np.linalg.norm(cams[i].C - cams[j].C))
        for g, j in enumerate(nbrs[:N]):
            neighbor_ids[i, g] = j
            pair_valid[i, g] = True
            F[i, g] = fundamental_matrix(centered[i], centered[j])

    return (segs, mask, cb.RtKinv.astype(np.float32), cb.C.astype(np.float32),
            cb.k_reg.astype(np.float32), neighbor_ids, F, pair_valid)


def _same_bits(a, b) -> bool:
    """Every field of two step outputs equal bit for bit."""
    return all(torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8))
               for x, y in zip(a, b))


def device_step_bench(V=26, S=3000, N=10, device=None) -> dict:
    """Times ``forward_step`` on ``make_workload(V, S, N)`` (``main``'s
    metric; the sizes are ``bench.py``'s by default) and prints the
    result, its JSON line last.  Returns that line's object under
    ``result`` beside ``runs_s``, ``median_s``, ``peak_device_GiB``,
    ``launches_per_run`` (each timed run's K1-K3 launches),
    ``same_outputs`` (every timed run equal bit for bit to the warm-up
    run) and ``card``."""
    dev = torch.device(device or device_for(False))
    args = tuple(torch.from_numpy(a).to(dev) for a in make_workload(V, S, N))
    on_card = dev.type == "cuda"
    card = card_line() if on_card else "CPU"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    synchronize(dev)
    want = forward_step(*args, **STEP_OPTIONS)     # warm-up: builds kernels
    synchronize(dev)

    times, launches, same = [], [], True
    for _ in range(RUNS):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = forward_step(*args, **STEP_OPTIONS)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        launches.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in STEP_KERNELS})
        same = same and _same_bits(got, want)
        del got

    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    for i, t in enumerate(times):
        print(f"run {i}: {t:.6f} s; launches {json.dumps(launches[i])}",
              flush=True)
    print(f"median {statistics.median(times):.6f} s; peak device memory "
          f"{'not measured on the CPU' if peak is None else f'{peak:.3f} GiB'}"
          f"; every run equal to the warm-up bit for bit: {same}",
          flush=True)
    print(card, flush=True)
    ips = V / min(times)
    where = (f"on {torch.cuda.get_device_name(dev)}" if on_card else
             "on the CPU, the kernels' plain torch versions; not a card "
             "measurement")
    result = {
        "metric": "device_step_images_per_sec",
        "value": round(ips, 3),
        "unit": (f"images/s ({V} views x {S} segs x {N} nbrs, matching+"
                 f"scoring+affinity, forward_step {where})"),
        "vs_baseline": (round(ips / BASELINE_IMAGES_PER_SEC, 2)
                        if on_card and (V, S, N) == (26, 3000, 10) else None),
    }
    print(json.dumps(result), flush=True)
    return dict(result=result, runs_s=times,
                median_s=statistics.median(times), peak_device_GiB=peak,
                launches_per_run=launches, same_outputs=same, card=card)


def images_e2e(items, config: Config | None = None, device=None):
    """The timed body of ``bench.py``'s cold pass (``run_testdata_e2e``)
    on ``items``, ``(cam_id, Camera, image)`` held in memory: ``Line3D``
    under ``config`` (default ``Config(optimize=False,
    load_segments=False)``: no segment cache), ``add_images`` (detection),
    ``match_images``, ``reconstruct_3d_lines``, on the card unless
    ``device`` names another.  Returns the image count, the seconds until
    the lines are on the host, and the pipeline (its ``lines3d`` are the
    lines)."""
    pipe = Line3D(config or Config(optimize=False, load_segments=False),
                  device=device)
    synchronize(pipe.device)
    t0 = time.perf_counter()
    pipe.add_images(items)
    pipe.match_images()
    pipe.reconstruct_3d_lines()
    synchronize(pipe.device)
    return len(items), time.perf_counter() - t0, pipe


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    return device_step_bench(device=device_for("--cpu" in argv))


if __name__ == "__main__":
    main()
