#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (line3dpp_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

1. Prints the card (``nvidia-smi`` name and power limit, device name and
   count); exits non-zero when no CUDA device is present.
2. Builds the CUDA kernels from ``line3dpp_tpu_torch/csrc`` (timed),
   prints ptxas' registers, shared memory and spills of every kernel, and
   counts the reject paths of K1 (SASS instructions per candidate) and K2
   (per slot pair) with ``cuobjdump -sass``, where the toolkit has it;
   holds ``sincosf`` (K8's gate) against ``sinf`` and ``cosf`` (K9's) bit
   for bit on all 2^32 float32 arguments (``SINCOS_CHECK_CU``), and the
   card's ``expf`` (the collinearity kernel's) against ``torch.exp``.
3. Cached segments to lines: loads the 26 bundled views and holds kernels
   K1-K3 against their plain PyTorch versions on the card at that path's
   shapes (26 views, S = 3000, N = 16, k = 10, M = 160), timing both with
   CUDA events, and counts K2's pre-test survivors for its bound (valid
   pairs x the pre-test's operations + survivors x the exact path's);
   then drives the path through the user entry points
   (``Line3D``, ``add_view``, ``match_images``, ``reconstruct_3d_lines``,
   ``save_txt/stl/obj``, ``save_bin`` in the boost and npz formats) with
   every launch counter reset just before and read just after; requires
   K1-K3 to have launched, ``load_bin`` of both ``.bin`` files to give the
   lines back, and the result to match ``testdata/out/...__vis_3.txt``
   (2276 lines) within 1% of its line count and at count_f1 >= 0.99 (1%
   scene scale).  Then the worldpoint neighbours end to end: the COLMAP
   model ``testdata/colmap_model/`` read with ``io.read_colmap`` and the
   26 cached segment sets through ``add_view(worldpoints=...)``
   (``colmap_phase``), and the item-13 options on the 26 views, the
   reference's (``perform_rdd``, ``collinearity_t``) and the repository's
   compensations (``split_bimodal_t``, ``split_strong_min``,
   ``cluster_strong_min``, ``match_rel_cut``) (``features_phase``, the
   collinearity and RDD calls profiled; the collinearity kernel launched
   once a reconstruction, and at most 8 device events and 2
   device-to-host copies inside ``recon.collinearity`` in a profiled
   reconstruction of the pipeline's own; the collinearity kernel on the
   call's inputs against the plain path bit for bit, twice, its kernels
   line row ``CL collinear_edges`` with its bound, ``CL_OPS_*``, and the
   plain path's time), each held to the main path's
   bounds (``SAME_*``) against ``tests/data/torch_colmap_26_jax_reference.npz``
   and ``torch_features_jax_reference.npz`` (written by
   ``tests/make_torch_colmap_reference.py`` and
   ``make_torch_features_reference.py`` with the JAX package on the CPU).
   Then K1 and K2 past the cells' k and M (``wide_kernel_checks``):
   K1 at k = 20 on the 416 pairs (a kernels-line row of its own) and at
   k = S = 3000 on views 0-2's 48 pairs (one all-matches block, the rows
   past its list printed) against the plain matcher bit for bit; K2
   against the plain scorer at knn = ``K2_WIDE_KNN`` (M = 1600, views
   0-2), bit for bit, and timed on the all-matches block (M = 48,000)
   with its records, the segments past them and the pre-test survivors
   counted for its bound (``sparse_pretest_counts``).  Then items 14 and
   15 through the entry points (``item14_15_phase``): the 26 views at
   ``view_block`` 4 and 13 (the fused TXT byte for byte, K1 and K2 once a
   block, no K3), the 104-view scene of ``tools/bench_scale.py`` (the
   port's ``tools.bench_scale.build_scene``) fused and at
   ``view_block=26`` (the same TXT), all matches (``knn=0``: auto-blocked
   at 3 with the JAX package's printed line, K1 and K2 once a block),
   ``knn=20`` fused, and the view-sharded step over NCCL at world size 1
   against ``forward_step`` bit for bit (``sharded_world1``).  Then the
   weak-scaling tool's path (``scaling_phase``): the sharded step at world
   size 1 on ``bench.make_workload(4, 1024, 6)`` under ``comm="tile"``
   and ``"gather"``, bit for bit equal with K1-K3 once a call under each,
   and ``python -m line3dpp_tpu_torch.tools.bench_scaling --devices 1``
   as a process of its own (its row checked); and the clustering records
   (``records_phase``): the 26 views under the compensations with
   ``L3D_SPLIT_DEBUG`` set, reconstructed with the record lists on and
   off (the TXT byte for byte, the ``emitted`` records exactly the lines,
   no node in two records, a split candidate and a visibility drop
   recorded, the counters printed once a call).  Then the same views
   under the default ``Config()`` (``bundled_cached``): the bundling kernel
   (``csrc/bundling.cu``, one launch a call) on the LM problem the JAX
   package assembled (``tests/data/torch_bundling_26_jax_reference.npz``,
   2295 clusters, 250 iterations) within ``LM_COST_RTOL`` of JAX's total
   cost, bit-identical twice, and within ``LM_PLAIN_RTOL`` of the plain
   loop's on the card (the kernels line's ``LM lm_bundle`` row: its
   bound, counted from the capture, and the plain loop's time), then the
   bundled path through the entry points against JAX's bundled lines.
4. Images to lines: renders the 10 views of the synthetic facade at
   3072 x 2304 (``utils/synthetic``), checks them against the digests of
   ``tests/data/torch_scene2_3072_jax_reference.npz`` (written by
   ``tests/make_torch_lsd_reference.py`` with the JAX package on the CPU),
   undistorts view 0 on the card against the port's CPU result
   (``UNDISTORT_COEFFS``, timed),
   holds the detection kernels K4-K11 against their plain versions
   on view 0's round-1 inputs and on synthetic full-size grids at a real
   photo's density (``FULL_SIZE_ACTIVE``) and with long edges
   (``synthetic_stripes``) (K7, K8 and K11 with the detector's run table
   and with the one their wrappers build; K7 and K8 also bit-identical in
   a second call; K6 with the map against K5 then K6 and K9's consume form
   against its gate and the mask, both also bit-identical in a second
   call), and K6 with the map and K9's consume form on the inputs that
   view 0's three rounds give them (``check_facade_rounds``), compares
   every view's
   detections with the JAX ones (``DETECT_*``), reconstructs from JAX's
   detections (JAX's lines at count_f1 >= 0.99, and count_f1, recall and
   precision against the 74 ground-truth lines within 0.02 of JAX's), and
   drives ``Line3D`` -> ``add_images`` -> ``match_images`` ->
   ``reconstruct_3d_lines`` -> ``save_*`` with the counters reset and read
   around it; requires every kernel to have launched and the ground-truth
   metrics within ``GT_SPREAD`` of JAX's, K6 with the map once per round
   and no K5.  Then the command line on the same views
   (``cli_phase``): the images written as binary PGM and their poses and
   worldpoints along the GT lines as an NVM, through
   ``line3dpp_tpu_torch.cli.run.main(["vsfm", ...])`` on the card twice on
   one output folder; the first run must detect the images -> lines
   phase's segments bit for bit and give the lines of an in-process
   ``Line3D`` fed them with the same worldpoints, the second must load the
   segment cache, detect nothing and write the same TXT.  Then the same images under
   ``Config(lsd_rescue=True)`` (rescue cascade with K10, bundling on)
   against ``tests/data/torch_scene2_3072_rescue_jax_reference.npz``, with
   the number of rescued rectangles of every view (``RESCUE_*``) and every
   kernel of detection required to have launched (``OFF_PATH`` are not);
   then view 0 with the ``rect_improve`` knob alone, the one path of K10's
   4-band form, with the counters reset and read around it
   (``detect_rect_improve``).
5. The port's drivers (``drivers_phase``), each with the launch counters
   reset just before and read just after: ``bench.device_step_bench`` at
   ``bench.py``'s size (26 views x 3000 segments x 10 neighbours, k = 10;
   three timed runs, each equal to the warm-up run bit for bit, K1, K2
   and K3 once a run), ``bench.images_e2e`` on the 10 facade views (the
   images phase's detections bit for bit and its detection launches),
   ``tools.bench_scale.main`` at its defaults (104 views, ``knn=10``,
   ``view_block=26``: the 104-view blocked run's lines), the two facade
   sweeps of ``tools.validate_scene2`` and ``validate_scene2_anchor`` on
   the same views (the ``(0.0, ordered)`` configuration's TXT byte for
   byte the images phase's), the eight configurations of both sweeps from
   JAX's facade detections against
   ``tests/data/torch_scene2_sweep_jax_reference.npz`` (written by
   ``tests/make_torch_scene2_sweep_reference.py`` with the JAX package on
   the CPU; ``SAME_*``, ``BUNDLED_SAME_F1`` with bundling), and
   ``tools.drive_synthetic`` (12 lines, recall and precision 1.0).
6. Prints one ``{"undistort": ...}`` line, one ``{"item11_13": ...}`` line
   (the CLI's, the COLMAP phase's and the item-13 phases' times), one
   ``{"item14_15": ...}`` line (the blocked, 104-view, all-matches, knn=20
   and sharded phases), one ``{"drivers": ...}`` line (the drivers'
   results and times), one ``{"scaling": ...}`` line (the tile/gather
   check and the tool's row, with the card's name and power limit), one
   ``{"records": ...}`` line (the counts by outcome, the split candidates
   and the printed counters), one ``{"facade_rounds": ...}``
   line (K6 with the map and K9's
   consume form on facade view 0's rounds, beside K5 + K6 and K9 with the
   torch tail they replace), one ``{"full_size": ...}`` line (the detection
   kernels on the synthetic grids), one ``{"kernels": [...]}`` line
   (``launches``: the rescue path's run; ``launches_default``: the
   ``Config(optimize=False)`` run, which launches no K10; K1 at k = 20:
   the ``knn=20`` run's, K1 and K2 on the all-matches block: the
   all-matches run's; the collinearity kernel:
   item 13's reference run, the only path that reaches it; neither
   launches K9's gate_pixels form or K10's 4-band form;
   ``launches_rect_improve``: the rect_improve detection), the nvidia-smi
   line, and last
   ``{"ok": true,
   "device": {...}}``.  Any failed check exits non-zero.

``--out DIR`` writes the build log (and the profiles) there; ``--profile``
adds a torch.profiler breakdown of one more ``match_images`` run, of the
detection of one facade view (plain and with the rescue) and of 25
bundling iterations.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(
    REPO, "testdata", "out",
    "Line3D-TPU__W_FULL__N_10__sigmaP_2.5__sigmaA_10__epiOverlap_0.25"
    "__kNN_10__vis_3.txt")
GOLDEN_LINES = 2276
SCENE2_NPZ = os.path.join(REPO, "tests", "data",
                          "torch_scene2_3072_jax_reference.npz")
RESCUE_NPZ = os.path.join(REPO, "tests", "data",
                          "torch_scene2_3072_rescue_jax_reference.npz")
BUNDLING_NPZ = os.path.join(REPO, "tests", "data",
                            "torch_bundling_26_jax_reference.npz")
COLMAP_NPZ = os.path.join(REPO, "tests", "data",
                          "torch_colmap_26_jax_reference.npz")
FEATURES_NPZ = os.path.join(REPO, "tests", "data",
                            "torch_features_jax_reference.npz")
SWEEP_NPZ = os.path.join(REPO, "tests", "data",
                         "torch_scene2_sweep_jax_reference.npz")
# lines against a JAX reference from the same segments (the main path's
# bounds): the count within 1% (at least one line), count_f1 at 1% scene
# scale
SAME_COUNT_REL = 0.01
SAME_F1 = 0.99
# facade worldpoints written into the CLI phase's NVM: points per GT line
NVM_POINTS_PER_LINE = 6

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12            # operations / s
PEAK_BYTES = 3.35e12        # bytes / s
H100_SMS = 132
LANES_PER_SM = 128          # 4 warp schedulers x 32 lanes issue per clock

# f32 operations per unit of work, counted from the kernels' source
K1_OPS_PER_CANDIDATE = 36   # 4 epipolar dots, 2 divisions, overlap (matching.cu)
K2_OPS_PER_PAIR = 40        # dot, acos, 3 exp, 2 divisions, min/max (scoring.cu)
K2_PRETEST_OPS_PER_PAIR = 12  # dot 5, 2 differences, 2 squares, 3 comparisons
K4_OPS_PER_ACTIVE = 16      # 4 backward links x angle_diff (lsd_cc.cu)
K7_OPS_PER_PIXEL = 13       # 6 products, 7 sums (lsd_fit.cu)
K9_OPS_PER_PIXEL = 50       # cosf, sinf (~20 each), projection, 3 tests
K10_OPS_PER_PIXEL = 8       # 2 differences, projection, s (lsd_fit.cu) ...
K10_OPS_PER_BAND = 6        # ... and per band 2 thresholds, 2 comparisons
K11_OPS_PER_PIXEL = 14      # 2 differences, 2 projections, 4 minima
# line bundling (bundling.cu), per observation: a Jacobian evaluation (5
# projections of 57, the line's norm and weight with their 4 tangents ~120,
# 2 residual rows and their Jacobians ~120, J^T J and g 56; asinf and expf
# ~20 each) and a cost evaluation (a projection, the weight, 2 residuals,
# Huber); per cluster, the frame and its tangents and, each iteration, the
# damped 4 x 4 solve and the update
LM_OPS_PER_JACOBIAN = 590
LM_OPS_PER_COST = 140
LM_OPS_PER_FRAME = 100
LM_OPS_PER_STEP = 90
# K2 against its plain version at this knn (M = 16 x 100, past the cells' 160)
K2_WIDE_KNN = 100
# the weak-scaling tool's defaults: make_workload(views, segments,
# neighbours) at one rank (4 views a shard), and its process's time limit
SCALING_WORKLOAD = (4, 1024, 6)
SCALING_TIMEOUT_S = 300
# the records phase: the compensations of item 13 (features_phase's)
RECORDS_OPTIONS = dict(optimize=False, split_bimodal_t=1.1,
                       split_strong_min=3.0, cluster_strong_min=3.0,
                       match_rel_cut=0.5)

# Facade bounds against the JAX reference.  The detections move with the
# order of the float32 moment sums, which JAX (one-hot products) and the
# port (float64) choose differently; tests/measure_torch_lsd_facade.py runs
# the port with 7 orders (float64, float32 in list order, float32 in 5
# random orders) on the 10 views.  Worst over those orders against JAX:
# per-view count 2.58% off, per-view coverage 0.9226, coverage over all
# views 0.9804, recall 0.0651 below JAX's (count_f1 0.0028, precision 0).
# Each bound leaves a margin below that worst case.
DETECT_COUNT_REL = 0.04
DETECT_VIEW_COVERAGE = 0.90
DETECT_ALL_COVERAGE = 0.97
GT_SPREAD = 0.08
# With the rescue cascade: the rectangles it rescues on the facade are 6 to
# 14 px leftovers of round 2, where a few pixels decide, so which are
# rescued moves with the order of the moment sums as well
# (tests/measure_torch_rescue_margin.py --shuffles 3, the port on the CPU
# under 5 orders, rescued rectangles per view against JAX's).  A view's
# count may differ from JAX's by RESCUE_VIEW_DIFF; each rectangle JAX
# rescued must lie within RESCUE_TOL_PX (larger endpoint distance) of a
# component of the port that is accepted, or that the cascade tried with
# its best log NFA over the 16 variants above -RESCUE_NFA_MARGIN (an
# aligned pixel is worth 0.9); a rectangle the port rescued lies as near a
# segment of JAX or passes by less than the margin.
RESCUE_VIEW_DIFF = 3
RESCUE_TOL_PX = 3.0
RESCUE_NFA_MARGIN = 4.5
# Bundled lines (optimize on) from the same detections against JAX's: two
# float32 Levenberg-Marquardt runs part where a cost comparison falls the
# other way, so the bound is a little below the unbundled 0.99.
BUNDLED_SAME_F1 = 0.97
# The port's LM on the problem JAX assembled for the 26 cached views
# (2295 clusters, 250 iterations): total robust cost at the start and at
# the end relative to JAX's.
LM_COST0_RTOL = 1e-4
LM_COST_RTOL = 1e-3
# the bundling kernel's total cost against the plain loop's on the card
# (tests/test_torch_bundling_cuda.py's TOTAL_RTOL; measured 1.79e-4, the
# plain loop on the CPU against the card 1.49e-4)
LM_PLAIN_RTOL = 5e-4
# active share of the synthetic full-size grids: real photos' round 1
# (30-47%), and 57% for a 2.8 M-pixel list (the JAX package's cap NC)
FULL_SIZE_ACTIVE = (0.30, 0.47, 0.57)
# what the full_size line keeps of each kernel's row
FULL_SIZE_KEYS = ("name", "max_abs_err", "ms", "device_ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms", "library_device_ms")
# kernels that neither images path launches (K5, and K6 without the map:
# the merged gather does their work; K9's gate_pixels form, which only the
# seed_gate and side_split knobs run: the consume step is K9's consume
# form, the rescue's p/2 retry a column of K10; K10's 4-band form, which
# only the rect_improve knob runs), and those only the rescue cascade does
# (K10's rescue form)
OFF_PATH = ("apply_merge_dense", "gather_labels", "gate_pixels",
            "band_counts")
RESCUE_ONLY = ("rescue_counts",)
# the kernels that only a Config with bundling (optimize) launches
BUNDLE_ONLY = ("lm_bundle",)
# ... and with collinearity edges (collinearity_t > 0)
COLLINEAR_ONLY = ("collinear_edges",)
# the collinearity kernel's operations: the pre-test (two numerators of 5
# and a comparison each) for every pair of segments both masked in and
# with an estimate, the exact 2D test (the numerators, four divisions and
# comparisons, the overlap projection and its clamps) for each pair that
# passes it, the 3D similarity (four distances, four exponentials, the
# minima) for each pair that passes the 2D test; and the plain path's
# count, which tests every pair i < j exactly (the every-pair bound)
CL_OPS_PRETEST = 12
CL_OPS_EXACT = 60
CL_OPS_SIMILARITY = 110
# the collinearity kernel's pre-test (csrc/collinearity.cu kMargin, kTiny)
# keeps a pair while |num| <= fl(fl(t Lc) * MARGIN) for both of the
# column's endpoints against the row's line: fl(|num| / Lc) < t implies
# |num| < t Lc <= fl(t Lc) / (1 - 2^-24), below that bound while fl(t Lc)
# is a normal float (CL_PRETEST_TINY); else it keeps the pair
CL_PRETEST_MARGIN = 1.0 + 2.0**-20
CL_PRETEST_TINY = 2.0**-126
# the long-edge grid: bands of this many rows of one angle, 47% active
STRIPE_ROWS = 8
STRIPE_ACTIVE = 0.47
# K8 gates with sincosf, K9 with sinf and cosf: their bits
# must agree for every float32 argument, so that K8's newpix equals K9's on
# any input.  This kernel compares them on all 2^32 bit patterns (a NaN
# result matches a NaN), built with the package's nvcc flags.  The same
# library maps expf over an array, for the collinearity kernel's weights,
# which must be torch.exp's bits (expf_differences).
SINCOS_CHECK_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void sincos_check(uint32_t z1, uint32_t z2,
                             unsigned long long* bad, unsigned int* first) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const uint32_t u = (uint32_t)i;
    float s, c;
    sincosf(__uint_as_float(u), &s, &c);
    // z1 = z2 = 0, which the compiler cannot know: sinf and cosf stay two
    // calls and are not merged into a sincosf
    const float s1 = sinf(__uint_as_float(u ^ z1));
    const float c1 = cosf(__uint_as_float(u ^ z2));
    const bool same =
        (__float_as_uint(s) == __float_as_uint(s1) || (s != s && s1 != s1)) &&
        (__float_as_uint(c) == __float_as_uint(c1) || (c != c && c1 != c1));
    if (!same) {
      atomicAdd(bad, 1ull);
      atomicMin(first, u);
    }
  }
}

extern "C" int l3d_check_sincos(unsigned long long* bad, unsigned int* first,
                                unsigned int z1, unsigned int z2,
                                void* stream) {
  sincos_check<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(z1, z2, bad,
                                                          first);
  return (int)cudaGetLastError();
}

__global__ void expf_map(const float* x, float* y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    y[i] = expf(x[i]);
}

// y = expf(x), the collinearity kernel's exponential, for comparison with
// torch.exp
extern "C" int l3d_expf(const float* x, float* y, long long n,
                        void* stream) {
  expf_map<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, keep: str | None = None):
    """``fn()`` under torch.profiler: the profile, the complete events of
    its trace and the wall seconds of the run.  The trace is also written
    to the path ``keep`` when it is small: a loop of thousands of small
    operations writes tens of MB."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        if keep and os.path.getsize(path) <= 8 << 20:
            os.makedirs(os.path.dirname(keep), exist_ok=True)
            shutil.move(path, keep)
    return prof, events, wall


def device_busy_us(events) -> tuple[float, int]:
    """Microseconds in which the card ran a kernel, a copy or a memset of
    ``events`` (the union of their intervals), and how many there were."""
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1.0
    for a, b in device:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy, len(device)


def span_device_events(events, name: str) -> tuple[int, int]:
    """How many device events of ``events`` a runtime call inside a span
    ``name`` launched (the same correlation id), and how many of them copy
    from the device to the host, as the benchmark's trace reader counts."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    inside = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and any(a <= launch.get(e.get("args", {}).get("correlation"),
                                      -1.0) <= b for a, b in spans)]
    return len(inside), sum(1 for e in inside if e.get("cat") == "gpu_memcpy"
                            and "DtoH" in e.get("name", ""))


def device_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call that the card itself spends on ``fn()``,
    without the host's share of the wrapper (its Python, the allocations,
    the launches): the stream first spins in a sleep kernel while the host
    queues all ``reps`` calls behind it, so the card then runs them back to
    back between the two events.  The sleep is doubled until it outlasts
    the queueing."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    cycles = 20_000_000
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        slept_s = time.perf_counter() - t0 - 1e-3 * start.elapsed_time(end)
        if queued_s < slept_s:
            return start.elapsed_time(end) / reps
        cycles *= 2
    fail("device_ms: the host never queued the calls within the sleep")


def device_sum_ms(fn, calls: int = 10) -> float:
    """Milliseconds per call of ``fn()`` that the card spends in kernels,
    copies and memsets (their durations summed, torch.profiler): the card's
    time of a call that syncs with the host, which ``device_ms`` cannot
    queue."""
    fn()
    _, events, _ = device_events(lambda: [fn() for _ in range(calls)])
    return 1e-3 * sum(e["dur"] for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")) / calls


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k2_bytes(args, got, valid_slots: int) -> int:
    """Bytes that kernel K2 must move: the validity table, the rays and the
    cameras read, the two depths of each valid slot read (those of an
    invalid slot are never read), score3d and valid written."""
    r1, r2, rmid, C, k_reg, tgt_C, tgt_k, d_p1, d_p2, valid = args
    return (nbytes(valid, r1, r2, rmid, C, k_reg, tgt_C, tgt_k)
            + (d_p1.element_size() + d_p2.element_size()) * valid_slots
            + nbytes(got.score3d, got.valid))


def check_k1(t, eo, knn):
    """K1 against its plain version; both read the same tables."""
    import torch
    from line3dpp_tpu_torch.ops import matching

    got = matching.match_pairs_cuda(t, eo, knn)
    want = matching.match_pairs_plain(t, eo, knn, chunk=8)
    torch.cuda.synchronize()
    n_valid = int(want.valid.sum())
    bad = int((got.valid != want.valid).sum()
              + ((got.tgt_seg != want.tgt_seg) & want.valid).sum())
    both = got.valid & want.valid & (got.tgt_seg == want.tgt_seg)
    err = max(float((getattr(got, f) - getattr(want, f))[both].abs().max())
              for f in ("overlap", "d_p1", "d_p2", "d_q1", "d_q2"))
    # same float32 expressions in the same order, no FMA contraction:
    # the kernel must select the same matches with the same depths
    print(f"K1 match_pairs: {n_valid} valid slots, {bad} differ, "
          f"max |err| {err:.3g}", flush=True)
    check(bad == 0 and err == 0.0, "K1 disagrees with its plain version")

    P, S = t.num_src.shape
    n_src = (t.mask[t.src_idx.long()] & t.pair_valid[:, None]).sum(1)
    n_tgt = t.mask[t.tgt_idx.long()].sum(1)
    candidates = int((n_src * n_tgt).sum())
    ops = K1_OPS_PER_CANDIDATE * candidates
    moved = nbytes(t.segments, t.mask, t.r1, t.r2, t.n, t.seglen, t.e1,
                   t.e2, t.num_src, t.num_tgt, t.src_idx, t.tgt_idx,
                   t.pair_valid) + nbytes(*got)
    k1 = lambda: matching.match_pairs_cuda(t, eo, knn)
    ms = cuda_ms(k1, reps=5)
    plain_ms = cuda_ms(lambda: matching.match_pairs_plain(t, eo, knn, 8),
                       reps=1)
    return got, (dict(
        name="K1 match_pairs", route="cuda",
        source="line3dpp_tpu_torch/csrc/matching.cu",
        replaces="line3dpp_tpu/ops/matching_pallas.py:233",
        max_abs_err=err, ms=ms, device_ms=device_ms(k1, 5),
        plain_ms=plain_ms,
        bound_ms=1e3 * max(ops / PEAK_F32, moved / PEAK_BYTES),
        bound_by="operations" if ops / PEAK_F32 > moved / PEAK_BYTES
        else "bytes", library_ms=None), candidates)


def pretest_counts(r1, r2, rmid, C, k_reg, tgt_C, tgt_k, d_p1, d_p2, valid,
                   *, knn: int, two_sig_a_sqr: float,
                   min_similarity: float = 0.5,
                   check_orientation: bool = True,
                   chunk: int = 256) -> dict:
    """What kernel K2's pre-test (``scoring.pretest_keeps_plain``) leaves
    on a match table, counted in torch: the valid pairs (valid slots after
    the orientation gate, other groups), those its angle test and its depth
    test keep, those both keep (the survivors); the warp steps of the
    kernel's layout (32 own slots, one partner) and of the other one (one
    own slot, the partners of a group) with a surviving lane; and the
    segments with no valid slot."""
    import torch
    from line3dpp_tpu_torch.ops import scoring

    V, S, M = d_p1.shape
    N = tgt_C.shape[1]
    VS = V * S
    dev = d_p1.device
    flat = lambda x: x.reshape(VS, *x.shape[2:])
    view_of = torch.arange(V, device=dev).repeat_interleave(S)
    group = torch.arange(M, device=dev) // knn
    other = group[:, None] != group[None, :]                      # (M, M)
    P = -(-M // 32)
    keeps = lambda *x: scoring.pretest_keeps_plain(*x, two_sig_a_sqr,
                                                   min_similarity)
    n = dict.fromkeys((
        "pairs", "angle_keeps", "depth_keeps", "survivors", "warp_steps",
        "warp_steps_survivor", "partner_steps", "partner_steps_survivor",
        "segments", "segments_no_valid"), 0)
    args = (flat(r1), flat(r2), flat(rmid), flat(d_p1), flat(d_p2),
            flat(valid))
    for lo in range(0, VS, chunk):
        sl = slice(lo, min(lo + chunk, VS))
        vv = view_of[sl]
        a1, a2, am, d1, d2, mv = (a[sl] for a in args)
        dirc, ok, den1, den2 = scoring._slot_geometry(
            a1, a2, am, d1, d2, mv, C[vv], k_reg[vv], tgt_C[vv], tgt_k[vv],
            knn=knn, check_orientation=check_orientation)
        pair = ok[:, :, None] & ok[:, None, :] & other
        dot = (dirc[0][:, :, None] * dirc[0][:, None, :]
               + dirc[1][:, :, None] * dirc[1][:, None, :]
               + dirc[2][:, :, None] * dirc[2][:, None, :])
        e1 = d1[:, :, None] - d1[:, None, :]
        e2 = d2[:, :, None] - d2[:, None, :]
        # each test alone: a zero depth difference or a unit dot passes
        # the other one
        zero, one = torch.zeros_like(e1), torch.ones_like(dot)
        keep = pair & keeps(dot, e1, e2, den1, den2)
        n["pairs"] += int(pair.sum())
        n["angle_keeps"] += int((pair & keeps(dot, zero, zero, den1,
                                              den2)).sum())
        n["depth_keeps"] += int((pair & keeps(one, e1, e2, den1,
                                              den2)).sum())
        n["survivors"] += int(keep.sum())
        # the kernel's lanes: own slot m is lane rank % 32 of pass rank // 32
        lane_pass = torch.where(ok, torch.cumsum(ok, 1) - 1, -1) // 32
        onehot = lane_pass[:, :, None] == torch.arange(P, device=dev)
        n["warp_steps"] += int((pair[:, :, :, None]
                                & onehot[:, :, None, :]).any(1).sum())
        n["warp_steps_survivor"] += int((keep[:, :, :, None]
                                         & onehot[:, :, None, :]).any(1).sum())
        by_group = lambda x: x.reshape(*x.shape[:2], N, knn).any(-1).sum()
        n["partner_steps"] += int(by_group(pair))
        n["partner_steps_survivor"] += int(by_group(keep))
        n["segments"] += ok.shape[0]
        n["segments_no_valid"] += int((~mv.any(1)).sum())
    return n


def check_k2(args, kw, sass=None, clock_mhz=None):
    """K2 against its plain version, with the counts of its pre-test
    (:func:`pretest_counts`) that its bound rests on: every valid pair
    needs the pre-test's operations, the survivors the exact path's."""
    import torch
    from line3dpp_tpu_torch.ops import scoring

    got = scoring.score_matches_cuda(*args, **kw)
    want = scoring.score_matches_plain(*args, chunk=2048, **kw)
    torch.cuda.synchronize()
    n_slots = got.score3d.numel()
    ok_bad = int((got.valid != want.valid).sum())
    diff = (got.score3d - want.score3d).abs()
    err = float(diff.max())
    n_far = int((diff > 1e-4).sum())
    # the same expressions in the same order; only acosf/expf may round
    # differently from torch's in the last bit, which can move a
    # similarity across min_similarity: allow 1 slot in 1e5 to differ
    # by more than 1e-4, none in validity
    print(f"K2 score_matches: {int(got.valid.sum())} valid slots, "
          f"{ok_bad} differ in validity, {n_far} by > 1e-4 in score, "
          f"max |err| {err:.3g}", flush=True)
    check(ok_bad == 0 and n_far <= 1e-5 * n_slots,
          "K2 disagrees with its plain version")

    n = pretest_counts(*args, chunk=512, **kw)
    pairs, survivors = n["pairs"], n["survivors"]
    print("K2 pre-test: " + json.dumps(n), flush=True)
    ops = K2_PRETEST_OPS_PER_PAIR * pairs + K2_OPS_PER_PAIR * survivors
    moved = k2_bytes(args, got, int(args[9].sum()))
    k2 = lambda: scoring.score_matches_cuda(*args, **kw)
    ms = cuda_ms(k2, reps=5)
    plain_ms = cuda_ms(
        lambda: scoring.score_matches_plain(*args, chunk=2048, **kw), reps=1)
    b_ms, by = bound(ops, moved)
    row = dict(
        name="K2 score_matches", route="cuda",
        source="line3dpp_tpu_torch/csrc/scoring.cu",
        replaces="line3dpp_tpu/ops/scoring_pallas.py:231",
        max_abs_err=err, ms=ms, device_ms=device_ms(k2, 5),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
        bound_ms_every_pair_exact=bound(K2_OPS_PER_PAIR * pairs, moved)[0],
        pretest_survivor_rate=survivors / max(pairs, 1),
        warp_step_survivor_rate=(n["warp_steps_survivor"]
                                 / max(n["warp_steps"], 1)))
    if sass is not None and clock_mhz:
        # every lane of the card issuing one reject-path instruction a clock
        row.update(sass_per_pair=sass["per_pair"], issue_ceiling_ms=(
            1e3 * sass["per_pair"] * pairs
            / (H100_SMS * LANES_PER_SM * clock_mhz * 1e6)))
        print(f"K2 issue-rate ceiling: {sass['per_pair']:.2f} SASS "
              f"instructions x {pairs} pairs over {H100_SMS} SMs x "
              f"{LANES_PER_SM} lanes at {clock_mhz:.0f} MHz = "
              f"{row['issue_ceiling_ms']:.3f} ms", flush=True)
    print(f"K2 bound: {pairs} pairs x {K2_PRETEST_OPS_PER_PAIR} + "
          f"{survivors} survivors x {K2_OPS_PER_PAIR} operations: "
          f"{b_ms:.4f} ms ({by}); every pair through the exact path "
          f"({K2_OPS_PER_PAIR} x {pairs}): "
          f"{row['bound_ms_every_pair_exact']:.4f} ms", flush=True)
    return got, (row, pairs)


def check_k3(fm, nbr, tgt_seg, knn):
    import torch
    from line3dpp_tpu_torch.ops import affinity

    table = affinity.estimate_table(fm.est_P1, fm.est_P2, fm.est_d1,
                                    fm.est_d2)
    est_valid = fm.est_valid.contiguous()
    nbr32 = nbr.to(torch.int32).contiguous()
    ts32 = tgt_seg.to(torch.int32).contiguous()
    got = affinity.gather_target_estimates_cuda(table, est_valid, nbr32,
                                                ts32, knn)
    plain = lambda: affinity.gather_target_estimates_plain(
        fm.est_P1, fm.est_P2, fm.est_d1, fm.est_d2, fm.est_valid, nbr,
        tgt_seg, knn)
    want = plain()
    torch.cuda.synchronize()
    planes = lambda g: torch.stack([*g.P1, *g.P2, g.d1, g.d2])
    exact = (torch.equal(planes(got), planes(want))
             and torch.equal(got.valid, want.valid))
    err = float((planes(got) - planes(want)).abs().max())
    print(f"K3 gather_target_estimates: bit-exact {exact}", flush=True)
    check(exact, "K3 is not bit-exact against its plain version")

    V, S, M = tgt_seg.shape
    flat = (nbr.long().repeat_interleave(knn, dim=1)[:, None, :] * S
            + tgt_seg.long()).reshape(-1)
    tab2 = table.reshape(-1, 8)
    library = lambda: torch.index_select(tab2, 0, flat)
    moved = nbytes(table, est_valid, nbr32, ts32) + nbytes(
        got.valid) + 8 * got.d1.numel() * 4
    k3 = lambda: affinity.gather_target_estimates_cuda(
        table, est_valid, nbr32, ts32, knn)
    return dict(
        name="K3 gather_target_estimates", route="cuda",
        source="line3dpp_tpu_torch/csrc/affinity_gather.cu",
        replaces="line3dpp_tpu/ops/affinity_pallas.py:76",
        max_abs_err=err,
        ms=cuda_ms(k3, reps=20), device_ms=device_ms(k3),
        plain_ms=cuda_ms(plain, reps=20),
        bound_ms=1e3 * moved / PEAK_BYTES, bound_by="bytes",
        library_ms=cuda_ms(library, reps=20),
        library_device_ms=device_ms(library))


def kernel_checks(inp, cfg, dev, k1_sass=None, k2_sass=None,
                  clock_mhz=None):
    """Each kernel against its plain version at the main path's shapes;
    K2 and K3 take the inputs the previous stages give them."""
    import torch
    from line3dpp_tpu_torch.models import step
    from line3dpp_tpu_torch.ops import affinity, matching

    d = {n: torch.from_numpy(inp[n]).to(dev) for n in (
        "segments", "seg_mask", "RtKinv", "C", "k_reg", "neighbor_ids", "F",
        "pair_valid")}
    V, N = d["neighbor_ids"].shape
    knn = inp["knn"]
    src = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(N)
    t = matching.pair_tables(d["segments"], d["seg_mask"], d["RtKinv"],
                             d["C"], src, d["neighbor_ids"].reshape(-1),
                             d["F"].reshape(-1, 3, 3),
                             d["pair_valid"].reshape(-1))
    print(f"main-path shapes: V={V} S={t.mask.shape[1]} N={N} k={knn} "
          f"M={N * knn} pairs={int(t.pair_valid.sum())}", flush=True)
    pm, (k1, candidates) = check_k1(t, cfg.epipolar_overlap, knn)
    print(f"K1 work: {candidates} candidate segment pairs", flush=True)
    if k1_sass and clock_mhz:
        # every lane of the card issuing one reject-path instruction a clock
        ceiling = 1e3 * k1_sass["per_candidate"] * candidates / (
            H100_SMS * LANES_PER_SM * clock_mhz * 1e6)
        print(f"K1 issue-rate ceiling: {k1_sass['per_candidate']:.2f} SASS "
              f"instructions x {candidates} candidates over {H100_SMS} SMs x "
              f"{LANES_PER_SM} lanes at {clock_mhz:.0f} MHz = {ceiling:.3f} "
              f"ms; bound {k1['bound_ms']:.3f} ms at "
              f"{K1_OPS_PER_CANDIDATE} f32 operations per candidate",
              flush=True)
        k1.update(sass_per_candidate=k1_sass["per_candidate"],
                  issue_ceiling_ms=ceiling)

    args, kw = scoring_inputs(d, pm, cfg, knn)
    scored, (k2, pairs) = check_k2(args, kw, k2_sass, clock_mhz)
    print(f"K2 work: {pairs} valid slot pairs", flush=True)

    r1, r2, _, _, _, _, _, d_p1, d_p2, _ = args
    tgt_seg = step.regroup(pm.tgt_seg, V, N).contiguous()
    fm = affinity.filter_matches(r1, r2, d["C"], scored.score3d,
                                 scored.valid, d_p1, d_p2,
                                 cfg.min_best_score_3d,
                                 cfg.min_best_score_perc)
    k3 = check_k3(fm, d["neighbor_ids"], tgt_seg, knn)
    return [k1, k2, k3]


def scoring_inputs(d, pm, cfg, knn):
    """Kernel K2's arguments and options on the main path: the match table
    of K1 (``pm``) regrouped by neighbour, the rays of the views ``d``."""
    from line3dpp_tpu_torch.models import step

    args = step.score_inputs(d["segments"], d["RtKinv"], d["C"], d["k_reg"],
                             d["neighbor_ids"], pm)
    kw = dict(knn=knn, two_sig_a_sqr=cfg.two_sig_a_sqr,
              min_similarity=cfg.min_similarity_3d,
              check_orientation=cfg.check_match_orientation)
    return args, kw


def consume_bytes(slot, xs, ys, ang, tables, survivors: int) -> int:
    """The bytes K9's consume form must move: slot, x, y and angle of every
    pixel, the tables, and per survivor its 8 B index and magnitude read and
    its index, magnitude and angle written (28 B)."""
    return nbytes(slot, xs, ys, ang, tables) + 28 * survivors


def half_band_pixels(slot, xs, ys, pix, tables, C: int) -> int:
    """The pixels whose angle K10's rescue form needs: those of a real
    component with ``pix != 0`` inside the p/2 retry's band ``|w_proj -
    mid| <= width / 2`` (``tables`` as ``lsd._band_tables`` builds them)."""
    import torch
    from line3dpp_tpu_torch.ops import lsd_fit

    row, valid = lsd_fit._rows(slot, tables, C)
    ct, st, cx, cy, mid, width = row[:, :6].unbind(1)
    d = (-(xs - cx) * st + (ys - cy) * ct) - mid
    g = torch.where(width > 0, 0.5 * width, -1.0)
    return int((valid & (pix != 0) & (d.abs() <= g)).sum())


def count_bytes(slot, xs, ys, pix, tables, bands, out,
                ang_pixels: int) -> int:
    """The bytes K10 must move: slot, x, y and pix of every pixel, the 4 B
    angle of the ``ang_pixels`` inside the p/2 band (0 without that
    column), the tables, the bands and the (C, columns) output; not the
    run table, which only the kernel's design needs."""
    return nbytes(slot, xs, ys, pix, tables, bands, out) + 4 * ang_pixels


def bound(ops: float, moved: float) -> tuple[float, str]:
    """Least time on the card in ms, and what bounds it."""
    t_ops, t_bytes = ops / PEAK_F32, moved / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def kernel_row(name, source, replaces, err, fn, plain_ms, ops, moved,
               library=None, card=None) -> dict:
    """The kernels line's entry of the wrapper call ``fn``: ``ms`` by CUDA
    events around 20 calls (the host's share of the wrapper included),
    ``device_ms`` the card's busy time per call (of ``card``, the launch
    alone, where the wrapper syncs with the host); the same two times of
    the PyTorch call ``library`` that computes the same function, where
    there is one, so that card compares with card and call with call."""
    b_ms, by = bound(ops, moved)
    row = dict(name=name, route="cuda",
               source=f"line3dpp_tpu_torch/csrc/{source}",
               replaces=replaces, max_abs_err=err, ms=cuda_ms(fn, 20),
               device_ms=device_ms(card or fn), plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=by, library_ms=None)
    if library is not None:
        row.update(library_ms=cuda_ms(library, 20),
                   library_device_ms=device_ms(library))
    return row


def render_scene(ref):
    """The 10 facade views at the reference's size; their digests must be
    the reference's."""
    from line3dpp_tpu_torch.utils import synthetic

    W, H = int(ref["width"]), int(ref["height"])
    quads, gt = synthetic.build_scene()
    cams = synthetic.make_cameras(10, width=W, height=H)
    t0 = time.perf_counter()
    images = [synthetic.render(c, quads, seed=100 + i, ss=1)
              for i, c in enumerate(cams)]
    render_s = time.perf_counter() - t0
    same = [synthetic.image_digest(im) == d
            for im, d in zip(images, ref["digests"])]
    print(f"rendered {len(images)} facade views at {W}x{H} in "
          f"{render_s:.2f} s; digests equal the reference's: {same}",
          flush=True)
    check(all(same), "rendered views differ from the reference's")
    return images, cams, gt, render_s


def synthetic_round1(frac: float, seed: int, dev):
    """Round-1 inputs on a full-size grid (3072 x 2304 images: 1920 x 2560,
    tiles 128 x 512) with ``frac`` of its pixels active, as real photos
    have 30-47% (the facade has 1-2%): level-line angles constant over 8 x 8
    blocks plus noise, so that components grow inside blocks and chain
    across blocks of similar angle."""
    import math
    import torch
    from line3dpp_tpu_torch.ops import lsd

    _, _, th, tw, hp, wp = lsd._statics(2304, 3072)
    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = (torch.rand((hp // 8, wp // 8), generator=g, device=dev)
              * (2 * math.pi) - math.pi)
    angle = (coarse.repeat_interleave(8, 0).repeat_interleave(8, 1)
             + 0.15 * torch.randn((hp, wp), generator=g, device=dev))
    active = torch.rand((hp, wp), generator=g, device=dev) < frac
    mag = 2.0 + 60.0 * torch.rand(hp * wp, generator=g, device=dev)
    idx = torch.nonzero(active.reshape(-1))[:, 0]
    return (angle.contiguous(), active, idx, mag[idx],
            angle.reshape(-1)[idx], (th, tw))


def synthetic_stripes(frac: float, seed: int, dev):
    """Round-1 inputs on the same full-size grid with long edges: bands of
    STRIPE_ROWS rows of one level-line angle each (no noise) and ``frac``
    of the pixels active, so that components run along the bands across
    many 32 x 128 patches of kernel K4, up to the tile borders: the patch
    design's worst case, where the 8 x 8 blocks of synthetic_round1 are its
    best."""
    import math
    import torch
    from line3dpp_tpu_torch.ops import lsd

    _, _, th, tw, hp, wp = lsd._statics(2304, 3072)
    g = torch.Generator(device=dev).manual_seed(seed)
    band = (torch.rand((hp // STRIPE_ROWS, 1), generator=g, device=dev)
            * (2 * math.pi) - math.pi)
    angle = band.repeat_interleave(STRIPE_ROWS, 0).expand(hp, wp)
    active = torch.rand((hp, wp), generator=g, device=dev) < frac
    mag = 2.0 + 60.0 * torch.rand(hp * wp, generator=g, device=dev)
    idx = torch.nonzero(active.reshape(-1))[:, 0]
    angle = angle.contiguous()
    return (angle, active, idx, mag[idx], angle.reshape(-1)[idx], (th, tw))


def sincos_library(start: bool = False):
    """The library of ``SINCOS_CHECK_CU`` under build/sincos_check/<hash>/:
    with ``start``, the nvcc process that builds it (None when it is
    built), else the loaded library."""
    from line3dpp_tpu_torch.ops import kernels

    h = hashlib.sha256((SINCOS_CHECK_CU + " ".join(kernels.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR),
                           "sincos_check", h)
    lib = os.path.join(out_dir, "libcheck.so")
    if start:
        if os.path.exists(lib):
            return None
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "check.cu")
        with open(src, "w") as f:
            f.write(SINCOS_CHECK_CU)
        return subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS,
                                 "-shared", src, "-o", lib],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    if not os.path.exists(lib):
        proc = sincos_library(start=True)
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"the sincosf check did not build: {out}")
    cdll = ctypes.CDLL(lib)
    cdll.l3d_check_sincos.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_uint] * 2 + [ctypes.c_void_p]
    cdll.l3d_check_sincos.restype = ctypes.c_int
    cdll.l3d_expf.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                      ctypes.c_void_p]
    cdll.l3d_expf.restype = ctypes.c_int
    return cdll


def sincos_differences(dev) -> tuple[int, int]:
    """How many float32 arguments ``sincosf`` and ``sinf``/``cosf`` give
    other bits for on the card, and the bits of the first (-1: none)."""
    import torch
    from line3dpp_tpu_torch.ops import kernels

    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    rc = sincos_library().l3d_check_sincos(
        kernels.ptr(bad), kernels.ptr(first), 0, 0, kernels.stream(dev))
    check(rc == 0, f"the sincosf check did not launch: CUDA error {rc}")
    return int(bad), (int(first) & 0xFFFFFFFF) if int(bad) else -1


def expf_differences(dev, chunk: int = 1 << 28) -> tuple[int, int]:
    """How many float32 arguments the card's ``expf`` (the collinearity
    kernel's) and ``torch.exp`` give other bits for (a NaN matches a NaN),
    over all 2^32 bit patterns, and the bits of the first (-1: none)."""
    import torch
    from line3dpp_tpu_torch.ops import kernels

    lib = sincos_library()
    bad, first = 0, -1
    for lo in range(0, 1 << 32, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int64, device=dev).to(
            torch.int32).view(torch.float32)
        y = torch.empty_like(x)
        rc = lib.l3d_expf(kernels.ptr(x), kernels.ptr(y), x.numel(),
                          kernels.stream(dev))
        check(rc == 0, f"the expf check did not launch: CUDA error {rc}")
        want = torch.exp(x)
        differ = ((y.view(torch.int32) != want.view(torch.int32))
                  & ~(torch.isnan(y) & torch.isnan(want)))
        n = int(differ.sum())
        if n and first < 0:
            first = lo + int(torch.nonzero(differ)[0])
        bad += n
    return bad, first


def ptxas_report(build_log: str) -> list[str]:
    """One line per kernel from the build log's ``ptxas -v`` report: the
    source, the kernel's name (demangled where cu++filt exists), its
    registers, shared memory and spills."""
    names = []
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            names.append(line.split("'")[1])
    demangled = dict(zip(names, names))
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if names and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            demangled = dict(zip(names, out.stdout.splitlines()))
    rows, src, name, spill = [], "", "", ""
    for line in build_log.splitlines():
        line = line.strip()
        if line.startswith("=="):
            src = line[2:].strip()
        elif "Compiling entry function" in line:
            name = demangled[line.split("'")[1]]
            name = (name.replace("(int)", "").replace("(bool)", "")
                    .split("(")[0])
            name = name.split("::")[-1]
        elif "spill stores" in line:
            spill = line
        elif line.startswith("ptxas info") and "Used" in line and name:
            rows.append(f"{src} {name}: {line.split(':', 1)[1].strip()}; "
                        f"{spill}")
            name = ""
    return rows


def k1_reject_path(sass: str) -> dict | None:
    """Instructions per candidate of K1's reject path in its scan,
    ``match_list_kernel``, from ``cuobjdump -sass``.  The step loop is the
    innermost loop that holds four or more LDS.128 (the targets' float4s)
    before its first forward branch (the write phase's rank loop reads
    its keys by LDS.128 too, but has no such branch): the pre-tests have
    no branch, so that branch skips the exact path when no target
    survives.  A step with no survivor runs from the loop head to that
    branch and from the branch's target to the back-edge; the step
    pre-tests as many targets as it has LDS.128 before the branch."""
    import re

    body = sass_function(sass, "match_list_kernel")
    if body is None:
        return None
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]

    def target(t):
        m = re.search(r"\bBRA\s+(?:!?U?P\d,\s*)?(0x[0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    def loads(lo, hi):
        return sum(1 for a, t in ins if lo <= a <= hi and "LDS.128" in t)

    branches = [(a, target(t)) for a, t in ins if target(t) is not None]
    for _, back, head in sorted((a - b, a, b) for a, b in branches
                                if b < a and loads(b, a) >= 4):
        fwd = [(a, b) for a, b in branches
               if head <= a < back and a < b <= back]
        if not fwd:
            continue
        skip, inc = min(fwd)
        group = loads(head, skip)
        if group >= 4:
            step = (skip - head) // 16 + 1 + (back - inc) // 16 + 1
            return dict(group=group, per_candidate=step / group, step=step)
    return None


def cuobjdump_sass(lib: str) -> str | None:
    """``cuobjdump -sass`` of the kernel library, where the toolkit has
    it."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("SASS: cuobjdump is absent from this toolkit; the reject "
              "paths are not counted", flush=True)
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        print(f"SASS: cuobjdump failed (rc {out.returncode})", flush=True)
        return None
    return out.stdout


def k1_sass_info(sass: str | None) -> dict | None:
    """K1's reject path in SASS instructions per candidate (printed)."""
    info = k1_reject_path(sass) if sass else None
    if sass and info is None:
        print("K1 SASS: match_list_kernel's pre-test step was not found "
              "in cuobjdump's output", flush=True)
    if info is None:
        return None
    print(f"K1 SASS, match_list_kernel: a step of {info['group']} "
          f"targets with no survivor "
          f"{info['step']}, so {info['per_candidate']:.2f} per candidate on "
          f"the reject path (K1_OPS_PER_CANDIDATE = {K1_OPS_PER_CANDIDATE} "
          f"stays the bound's yardstick)", flush=True)
    return info


def sass_function(sass: str, name: str) -> str | None:
    """The body of the first kernel in ``sass`` whose mangled name holds
    ``name``."""
    return next((f for f in sass.split("Function : ")[1:]
                 if name in f.split("\n", 1)[0]), None)


def k2_reject_path(sass: str) -> dict | None:
    """Instructions per pair of K2's reject path in ``score_all_kernel``,
    from ``cuobjdump -sass``: its pre-test of 32 partners is unrolled and
    branch-free, so it is the basic block without a MUFU (the exact path's
    acosf and expf) that reads the most partners' float4s (LDS.128); per
    pair, that block's instructions over its LDS.128."""
    import re

    body = sass_function(sass, "score_all_kernel")
    if body is None:
        return None
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    targets = set()
    for _, t in ins:
        m = re.search(r"\bBRA\s+(?:!?U?P\d,\s*)?(0x[0-9a-f]+)", t)
        if m:
            targets.add(int(m.group(1), 16))
    blocks, cur = [], []
    for a, t in ins:
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(t)
        if re.search(r"\b(BRA|EXIT|RET|CALL|BSYNC|WARPSYNC|BREAK)\b", t):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    best = None
    for blk in blocks:
        lds = sum("LDS.128" in t for t in blk)
        if lds < 8 or any("MUFU" in t for t in blk):
            continue
        if best is None or lds > best["partners"]:
            best = dict(partners=lds, step=len(blk), per_pair=len(blk) / lds)
    return best


def k2_sass_info(sass: str | None) -> dict | None:
    """K2's reject path in SASS instructions per pair (printed)."""
    info = k2_reject_path(sass) if sass else None
    if sass and info is None:
        print("K2 SASS: score_all_kernel's pre-test block was not found in "
              "cuobjdump's output", flush=True)
    if info is None:
        return None
    print(f"K2 SASS, score_all_kernel: the pre-test of "
          f"{info['partners']} partners is {info['step']} instructions, so "
          f"{info['per_pair']:.2f} per pair on the reject path "
          f"(K2_PRETEST_OPS_PER_PAIR = {K2_PRETEST_OPS_PER_PAIR} stays the "
          f"bound's yardstick)", flush=True)
    return info


def check_lsd_kernels(angle, active, idx, mag_c, ang_c, tile, dev,
                      what: str):
    """K4-K11 against their plain versions on one grid's round-1 inputs,
    with times and bounds."""
    import torch
    from line3dpp_tpu_torch.ops import lsd, lsd_cc, lsd_fit, lsd_gather

    hp, wp = angle.shape
    tol = lsd.PREC
    n_active = int(active.sum())
    rows = []

    # K4: bit-exact labels, nothing unconverged
    lab, unconv = lsd_cc.cc_tiles_cuda(angle, active, tol, tile)
    want, _ = lsd_cc.cc_tiles_plain(angle, active, tol, tile)
    torch.cuda.synchronize()
    exact = torch.equal(lab, want)
    print(f"[{what}] K4 cc_tiles: grid {hp}x{wp}, tiles {tile[0]}x{tile[1]}, "
          f"{n_active} active pixels ({n_active / (hp * wp):.3f}), "
          f"{int(torch.unique(want[active]).numel())} tile components; "
          f"bit-exact {exact}, unconverged {int(unconv)}", flush=True)
    check(exact and int(unconv) == 0, "K4 disagrees with its plain version")
    rows.append(kernel_row(
        "K4 cc_tiles", "lsd_cc.cu", "line3dpp_tpu/ops/lsd_cc.py:146", 0.0,
        lambda: lsd_cc.cc_tiles_cuda(angle, active, tol, tile),
        cuda_ms(lambda: lsd_cc.cc_tiles_plain(angle, active, tol, tile), 1),
        K4_OPS_PER_ACTIVE * n_active, nbytes(angle, active, lab, unconv)))

    # K5 and K6 on the border merge's map: bit-exact
    T, n_links = lsd_cc.merge_tile_labels(lab, angle, active, tol, tile)
    dense = lsd_gather.apply_merge_dense_cuda(lab, T)
    flat = dense.reshape(-1)
    got6 = lsd_gather.gather_labels_cuda(flat, idx)
    exact5 = torch.equal(dense, lsd_gather.apply_merge_dense_plain(lab, T))
    exact6 = torch.equal(got6, lsd_gather.gather_labels_plain(flat, idx))
    print(f"[{what}] K5 apply_merge_dense: {n_links} border links, bit-exact "
          f"{exact5}; K6 gather_labels: {idx.numel()} pixels, bit-exact "
          f"{exact6}", flush=True)
    check(exact5, "K5 is not bit-exact against its plain version")
    check(exact6, "K6 is not bit-exact against its plain version")
    rows.append(kernel_row(
        "K5 apply_merge_dense", "lsd_gather.cu",
        "line3dpp_tpu/ops/lsd_gather.py:141", 0.0,
        lambda: lsd_gather.apply_merge_dense_cuda(lab, T),
        cuda_ms(lambda: lsd_gather.apply_merge_dense_plain(lab, T), 20),
        0, nbytes(lab, dense) + 4 * n_active))
    rows.append(kernel_row(
        "K6 gather_labels", "lsd_gather.cu",
        "line3dpp_tpu/ops/lsd_gather.py:266", 0.0,
        lambda: lsd_gather.gather_labels_cuda(flat, idx),
        cuda_ms(lambda: lsd_gather.gather_labels_plain(flat, idx), 20),
        0, nbytes(idx, got6) + 4 * idx.numel(),
        library=lambda: torch.index_select(flat, 0, idx)))

    # K6 with the map, as _pixel_list calls it: bit for bit its plain
    # version and K5 then K6, and the same bits in a second call
    got_m = lsd_gather.gather_merged_cuda(lab, T, idx)
    again_m = lsd_gather.gather_merged_cuda(lab, T, idx)
    exact_m = (torch.equal(got_m, lsd_gather.gather_merged_plain(lab, T, idx))
               and torch.equal(got_m, got6))
    print(f"[{what}] K6 gather_merged: {idx.numel()} pixels, bit-exact "
          f"against its plain version and K5 then K6 {exact_m}; two calls "
          f"bit-identical: {torch.equal(got_m, again_m)}", flush=True)
    check(exact_m, "K6 gather_merged differs from its plain version or "
                   "from K5 then K6")
    check(torch.equal(got_m, again_m), "K6 gather_merged gives other bits "
                                       "in another call")
    lab_flat = lab.reshape(-1)
    check(bool((lab_flat[idx] < lab.numel()).all()),
          "a listed pixel without a label")
    rows.append(kernel_row(
        "K6 gather_merged", "lsd_gather.cu",
        "line3dpp_tpu/ops/lsd_gather.py:266", 0.0,
        lambda: lsd_gather.gather_merged_cuda(lab, T, idx),
        cuda_ms(lambda: lsd_gather.gather_merged_plain(lab, T, idx), 20),
        # the function's bytes: an 8 B index, its label, the label's map
        # entry and the 4 B output per listed pixel
        0, nbytes(idx, got_m) + 8 * idx.numel(),
        library=lambda: torch.index_select(
            T, 0, torch.index_select(lab_flat, 0, idx))))

    pl = lsd._pixel_list(angle, active, idx, mag_c, ang_c, tol, tile)
    n, C = pl["n"], pl["C"]
    slot, xs, ys = pl["slot"], pl["xs"], pl["ys"]
    mag, ang = pl["mag_s"], pl["ang_s"]
    n_real = int((slot < C).sum())
    pix = torch.ones(n, dtype=torch.float32, device=dev)
    print(f"[{what}] round-1 pixel list: {n} pixels, {C} components (runs "
          f">= 5), {n_real} pixels in them", flush=True)

    # K7: float64 sums in both versions; they may differ in the last bit of
    # the float32 result only.  With the detector's run table, as
    # _lsd_round calls it, and without (the wrapper builds it); the order
    # of the sums is fixed, so a second call gives the same bits.
    def rel_err(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    def same_bits(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    starts = pl["starts"]
    mom = lsd_fit.moments_cuda(slot, xs, ys, mag, pix, C, starts)
    mom_again = lsd_fit.moments_cuda(slot, xs, ys, mag, pix, C, starts)
    mom_built = lsd_fit.moments_cuda(slot, xs, ys, mag, pix, C)
    mom_p = lsd_fit.moments_plain(slot, xs, ys, mag, pix, C)
    torch.cuda.synchronize()
    err7 = max(rel_err(mom, mom_p), rel_err(mom_built, mom_p))
    repeat7 = same_bits(mom, mom_again) and same_bits(mom, mom_built)
    print(f"[{what}] K7 moments: max rel err {err7:.3g} (limit 1e-6), max "
          f"|err| {float((mom - mom_p).abs().max()):.3g} (run table given "
          f"and built); two calls bit-identical: {repeat7}", flush=True)
    check(err7 <= 1e-6, "K7 disagrees with its plain version")
    check(repeat7, "K7 gives other bits in another call")
    terms = lsd_fit._moment_terms(xs, ys, mag, pix)
    acc7 = torch.zeros((C + 1, 7), dtype=torch.float32, device=dev)
    slot_l = slot.long()
    rows.append(kernel_row(
        "K7 moments", "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:137",
        float((mom - mom_p).abs().max()),
        lambda: lsd_fit.moments_cuda(slot, xs, ys, mag, pix, C, starts),
        cuda_ms(lambda: lsd_fit.moments_plain(slot, xs, ys, mag, pix, C), 5),
        # the function's bytes: five pixel planes and the (C, 8) output;
        # not the run table, which only this kernel's design needs
        K7_OPS_PER_PIXEL * n_real, nbytes(slot, xs, ys, mag, pix, mom),
        library=lambda: acc7.index_add_(0, slot_l, terms)))

    # the first fit's tables, and K11 on them: exact minima
    # with the detector's run table, as _lsd_round calls it, and without
    tables, npix, _ = lsd._axis_tables(mom_p)
    ext = lsd_fit.extents_cuda(slot, xs, ys, pix, tables, C, starts)
    ext_built = lsd_fit.extents_cuda(slot, xs, ys, pix, tables, C)
    ext_p = lsd_fit.extents_plain(slot, xs, ys, pix, tables, C)
    torch.cuda.synchronize()
    exact = (torch.equal(ext.view(torch.int32), ext_p.view(torch.int32))
             and torch.equal(ext_built.view(torch.int32),
                             ext_p.view(torch.int32)))
    print(f"[{what}] K11 extents: bit-exact {exact} (run table given and "
          f"built)", flush=True)
    check(exact, "K11 is not bit-exact against its plain version")
    row = tables[slot.clamp(max=C - 1).long()]
    dxp, dyp = xs - row[:, 2], ys - row[:, 3]
    lp = dxp * row[:, 0] + dyp * row[:, 1]
    wproj = -dxp * row[:, 1] + dyp * row[:, 0]
    vals = torch.where(((slot < C) & (pix != 0))[:, None],
                       torch.stack([lp, wproj, -lp, -wproj], 1), lsd_fit.BIG)
    acc11 = torch.full((C + 1, 4), lsd_fit.BIG, device=dev)
    idx4 = slot_l[:, None].expand(-1, 4)
    rows.append(kernel_row(
        "K11 extents", "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:530", 0.0,
        lambda: lsd_fit.extents_cuda(slot, xs, ys, pix, tables, C, starts),
        cuda_ms(lambda: lsd_fit.extents_plain(slot, xs, ys, pix, tables, C),
                5),
        # the function's bytes: four pixel planes, each component's
        # (cos, sin, cx, cy) of the table, the (C, 4) output; not the run
        # table, which only this kernel's design needs
        K11_OPS_PER_PIXEL * n_real, nbytes(slot, xs, ys, pix, ext) + 16 * C,
        library=lambda: acc11.scatter_reduce_(0, idx4, vals, "amin")))

    # the first refine step's gate, as _lsd_round builds it: K8 against its
    # plain version and its newpix against K9's on the same inputs
    f = lsd._rectangles(tables, npix, ext_p)
    t8 = lsd._with_gate(f, lsd._refine_gate(f)[0])
    args8 = (slot, xs, ys, ang, mag, pix, t8, True, lsd.COS_GATE, C)
    np8, mom8 = lsd_fit.gate_moments_cuda(*args8, starts)
    np8_again, mom8_again = lsd_fit.gate_moments_cuda(*args8, starts)
    np8_built, mom8_built = lsd_fit.gate_moments_cuda(*args8)
    np8_k9 = lsd_fit.gate_pixels_cuda(slot, xs, ys, ang, pix, t8, True,
                                      lsd.COS_GATE, C)
    np8_p = lsd_fit.gate_pixels_plain(slot, xs, ys, ang, pix, t8, True,
                                      lsd.COS_GATE, C)
    mom8_p = lsd_fit.moments_plain(slot, xs, ys, mag, np8_p, C)
    torch.cuda.synchronize()
    flip8 = np8 != np8_p
    # components with a flipped pixel have other sums: compare the rest
    clean = torch.ones(C + 1, dtype=torch.bool, device=dev)
    clean[slot_l[flip8]] = False
    err8 = max(rel_err(mom8[clean[:C]], mom8_p[clean[:C]]),
               rel_err(mom8_built[clean[:C]], mom8_p[clean[:C]]))
    repeat8 = (torch.equal(np8, np8_again) and torch.equal(np8, np8_built)
               and same_bits(mom8, mom8_again)
               and same_bits(mom8, mom8_built))
    print(f"[{what}] K8 gate_moments: {int(np8.sum())} of {n} pixels kept, "
          f"{int(flip8.sum())} differ from the plain gate (limit "
          f"{1e-5 * n:.1f}), newpix equals K9's: "
          f"{torch.equal(np8, np8_k9)}, max rel err of the sums {err8:.3g} "
          f"(limit 1e-6; run table given and built); two calls "
          f"bit-identical: {repeat8}", flush=True)
    check(int(flip8.sum()) <= 1e-5 * n and torch.equal(np8, np8_k9)
          and err8 <= 1e-6, "K8 disagrees with its plain version")
    check(repeat8, "K8 gives other bits in another call")
    rows.append(kernel_row(
        "K8 gate_moments", "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:368",
        float((mom8 - mom8_p)[clean[:C]].abs().max()),
        lambda: lsd_fit.gate_moments_cuda(*args8, starts),
        cuda_ms(lambda: lsd_fit.moments_plain(
            slot, xs, ys, mag, lsd_fit.gate_pixels_plain(
                slot, xs, ys, ang, pix, t8, True, lsd.COS_GATE, C), C), 5),
        (K9_OPS_PER_PIXEL + K7_OPS_PER_PIXEL) * n_real,
        nbytes(slot, xs, ys, ang, mag, pix, t8, np8, mom8)))

    # the consume gate, every component as if accepted: K9
    t9 = lsd._consume_tables(f, torch.ones(C, dtype=torch.bool, device=dev))
    args9 = (slot, xs, ys, ang, pix, t9, False, lsd.COS_GATE, C)
    np9 = lsd_fit.gate_pixels_cuda(*args9)
    np9_p = lsd_fit.gate_pixels_plain(*args9)
    torch.cuda.synchronize()
    flip9 = int((np9 != np9_p).sum())
    print(f"[{what}] K9 gate_pixels: {int(np9.sum())} of {n} pixels in "
          f"accepted bands, {flip9} differ from the plain version (limit "
          f"{1e-5 * n:.1f})", flush=True)
    check(flip9 <= 1e-5 * n, "K9 disagrees with its plain version")
    rows.append(kernel_row(
        "K9 gate_pixels", "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:402",
        float(flip9),
        lambda: lsd_fit.gate_pixels_cuda(*args9),
        cuda_ms(lambda: lsd_fit.gate_pixels_plain(*args9), 5),
        K9_OPS_PER_PIXEL * n_real, nbytes(slot, xs, ys, ang, pix, t9, np9)))

    # K9's consume form on the same tables: bit for bit the gate above
    # (pix = 1, no dump pixel kept) and the mask, count included; the same
    # bits in a second call
    idx_s = pl["idx_s"]
    args_c = (slot, xs, ys, idx_s, mag, ang, t9, lsd.COS_GATE, C)
    surv = lsd_fit.consume_survivors_cuda(*args_c)
    surv_again = lsd_fit.consume_survivors_cuda(*args_c)
    alive = np9 == 0.0
    same_c = all(torch.equal(g, v[alive]) for g, v in zip(surv, (idx_s, mag,
                                                                 ang)))
    repeat_c = all(torch.equal(a, b) for a, b in zip(surv, surv_again))
    print(f"[{what}] K9 consume_survivors: {surv[0].numel()} of {n} pixels "
          f"survive; equal to K9's gate and the mask (count included): "
          f"{same_c}; two calls bit-identical: {repeat_c}; {flip9} gates "
          f"differ from the plain version (limit {1e-5 * n:.1f})", flush=True)
    check(same_c, "K9's consume form differs from its gate and the mask")
    check(repeat_c, "K9's consume form gives other bits in another call")
    outs_c = (torch.empty_like(idx_s), torch.empty_like(mag),
              torch.empty_like(ang),
              torch.empty(1, dtype=torch.int32, device=dev))
    rows.append(kernel_row(
        "K9 consume_survivors", "lsd_fit.cu",
        "line3dpp_tpu/ops/lsd_fit.py:402", float(flip9),
        lambda: lsd_fit.consume_survivors_cuda(*args_c),
        cuda_ms(lambda: lsd_fit.consume_survivors_plain(*args_c), 5),
        K9_OPS_PER_PIXEL * n_real,
        consume_bytes(slot, xs, ys, ang, t9, surv[0].numel()),
        card=lambda: lsd_fit.consume_survivors_into(*args_c, *outs_c)))

    # the rescue cascade's counts (the p/2 retry and the 15 bands in one
    # pass) and rect_improve's 4 bands on the first fit's rectangles, as
    # _rescue and _rect_improve build the tables: K10, integer counts,
    # exact, the same bits in a second call
    t10 = lsd._band_tables(f)
    n_ang = half_band_pixels(slot, xs, ys, pix, t10, C)
    for name, bands in (("K10 rescue_counts", lsd.RESCUE_BANDS),
                        ("K10 band_counts", lsd_fit.SYM_BANDS)):
        bt = torch.tensor(bands, dtype=torch.float32, device=dev)
        if name.endswith("rescue_counts"):
            args10 = (slot, xs, ys, ang, pix, t10, C, bt, lsd.COS_GATE_HALF)
            k10 = lambda args=args10: lsd_fit.rescue_counts_cuda(*args,
                                                                 starts)
            plain = lambda args=args10: lsd_fit.rescue_counts_plain(*args)
            ops = K9_OPS_PER_PIXEL * n_ang
        else:
            args10 = (slot, xs, ys, pix, t10, C, bt)
            k10 = lambda args=args10: lsd_fit.band_counts_cuda(*args, starts)
            plain = lambda args=args10: lsd_fit.band_counts_plain(*args)
            ops = 0
        cnt, again, cnt_p = k10(), k10(), plain()
        torch.cuda.synchronize()
        exact, repeat = torch.equal(cnt, cnt_p), torch.equal(cnt, again)
        plain10 = cuda_ms(plain, 5)
        print(f"[{what}] {name}, {cnt.shape[1]} columns: {int(cnt.sum())} "
              f"pixel-column hits, {n_ang} pixels inside the p/2 band; "
              f"equal to the plain version {exact}, two calls identical "
              f"{repeat}; {cuda_ms(k10, 20):.4f} ms, on the card "
              f"{device_ms(k10):.4f} ms, plain {plain10:.3f} ms", flush=True)
        check(exact, f"{name} differs from its plain version")
        check(repeat, f"{name} gives other counts in another call")
        ops += (K10_OPS_PER_PIXEL + K10_OPS_PER_BAND * len(bands)) * n_real
        rows.append(kernel_row(
            name, "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:498",
            float((cnt - cnt_p).abs().max()), k10, plain10, ops,
            count_bytes(slot, xs, ys, pix, t10, bt, cnt,
                        n_ang if name.endswith("rescue_counts") else 0)))
    return rows


def record_rounds(img) -> dict:
    """The arguments of every call of K6 with the map (``gather``) and of
    K9's consume form (``consume``) in one detection of ``img``, cloned, in
    the order of the rounds."""
    import torch
    from line3dpp_tpu_torch.ops import lsd, lsd_fit, lsd_gather

    calls = {"gather": [], "consume": []}
    orig = lsd_gather.gather_merged, lsd_fit.consume_survivors

    def record(kind, fn):
        def call(*args):
            calls[kind].append(tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args))
            return fn(*args)
        return call

    lsd_gather.gather_merged = record("gather", orig[0])
    lsd_fit.consume_survivors = record("consume", orig[1])
    try:
        lsd._lsd_core(img)
    finally:
        lsd_gather.gather_merged, lsd_fit.consume_survivors = orig
    return calls


def check_facade_rounds(img, dev) -> dict:
    """K6 with the map on the three rounds and K9's consume form on the two
    consume rounds of one facade view, on the inputs the detector gives
    them (recorded in one detection, the consume tables from the round's
    accepted rectangles): bit for bit their plain version and K5 then K6,
    and K9's gate_pixels form and the mask (count included), within the
    gate flips of the plain version; the same bits in a second call.
    Returns per call the card times and wrapper times beside those of what
    they replace (K5 + K6; K9 + the torch tail of three mask indexings)."""
    import torch
    from line3dpp_tpu_torch.ops import lsd_fit, lsd_gather

    calls = record_rounds(img)
    check(len(calls["gather"]) == 3 and len(calls["consume"]) == 2,
          f"facade view 0 ran {len(calls['gather'])} gathers and "
          f"{len(calls['consume'])} consume steps, not 3 and 2")
    out = {}
    for r, (lab, T, idx) in enumerate(calls["gather"], 1):
        def k5_k6(lab=lab, T=T, idx=idx):
            return lsd_gather.gather_labels_cuda(
                lsd_gather.apply_merge_dense_cuda(lab, T).reshape(-1), idx)

        def k6(lab=lab, T=T, idx=idx):
            return lsd_gather.gather_merged_cuda(lab, T, idx)

        got = k6()
        exact = (torch.equal(got, lsd_gather.gather_merged_plain(lab, T, idx))
                 and torch.equal(got, k5_k6()) and torch.equal(got, k6()))
        n = idx.numel()
        row = dict(pixels=n, bit_exact=exact, device_ms=device_ms(k6),
                   ms=cuda_ms(k6, 20), k5_k6_device_ms=device_ms(k5_k6),
                   k5_k6_ms=cuda_ms(k5_k6, 20),
                   bound_ms=bound(0, nbytes(idx, got) + 8 * n)[0])
        print(f"[facade view 0, round {r}] K6 gather_merged: "
              f"{json.dumps(row)}", flush=True)
        check(exact, f"round {r}: K6 gather_merged differs from its plain "
                     f"version, from K5 then K6 or from a second call")
        out[f"round {r} K6 gather_merged"] = row
    for r, args in enumerate(calls["consume"], 1):
        slot, xs, ys, idx_s, mag, ang, tables, cos_tol, C = args
        gate_args = (slot, xs, ys, ang, torch.ones_like(xs), tables, False,
                     cos_tol, C)

        def k9_tail(args=args):
            # the consume step before K9's consume form: a fill of ones,
            # K9, two element-wise passes and three mask indexings
            slot, xs, ys, idx_s, mag, ang, tables, cos_tol, C = args
            alive = ~(lsd_fit.gate_pixels_cuda(
                slot, xs, ys, ang, torch.ones_like(xs), tables, False,
                cos_tol, C) != 0.0)
            return idx_s[alive], mag[alive], ang[alive]

        outs = (torch.empty_like(idx_s), torch.empty_like(mag),
                torch.empty_like(ang),
                torch.empty(1, dtype=torch.int32, device=dev))
        got = lsd_fit.consume_survivors_cuda(*args)
        again = lsd_fit.consume_survivors_cuda(*args)
        alive = lsd_fit.gate_pixels_cuda(*gate_args) == 0.0
        flips = int((alive != (lsd_fit.gate_pixels_plain(*gate_args)
                               == 0.0)).sum())
        same = all(torch.equal(g, v[alive]) and torch.equal(g, a)
                   for g, a, v in zip(got, again, (idx_s, mag, ang)))
        n = slot.numel()
        row = dict(
            pixels=n, components=C, survivors=got[0].numel(),
            equals_gate_and_mask=same, plain_flips=flips,
            device_ms=device_ms(
                lambda: lsd_fit.consume_survivors_into(*args, *outs)),
            device_sum_ms=device_sum_ms(
                lambda: lsd_fit.consume_survivors_cuda(*args)),
            ms=cuda_ms(lambda: lsd_fit.consume_survivors_cuda(*args), 20),
            k9_device_ms=device_ms(
                lambda: lsd_fit.gate_pixels_cuda(*gate_args)),
            k9_tail_device_sum_ms=device_sum_ms(k9_tail),
            k9_tail_ms=cuda_ms(k9_tail, 20),
            bound_ms=bound(K9_OPS_PER_PIXEL * int((slot < C).sum()),
                           consume_bytes(slot, xs, ys, ang, tables,
                                         got[0].numel()))[0])
        print(f"[facade view 0, round {r}] K9 consume_survivors: "
              f"{json.dumps(row)}", flush=True)
        check(same and flips <= 1e-5 * n, f"round {r}: K9's consume form "
              f"differs from its gate and the mask, from a second call or "
              f"from the plain version")
        out[f"round {r} K9 consume_survivors"] = row
    return out


def rescue_differences(view, ref_rescued, ref_segs, segs, ok, diag) -> list:
    """Holds one view's rescue cascade against JAX's, rectangle by
    rectangle.  A rectangle JAX rescued must be among the port's accepted
    segments (both endpoints within ``RESCUE_TOL_PX``), or be a component
    of the port that the cascade tried and whose best log NFA over the 16
    variants is less than ``RESCUE_NFA_MARGIN`` below the threshold; a
    rectangle the port rescued must be among JAX's segments or pass by
    less than the margin.  Prints every difference and returns those that
    neither rule explains."""
    from line3dpp_tpu_torch.utils import golden

    segs = segs.cpu().numpy().astype(np.float64)
    ok = ok.cpu().numpy()
    rescued, attempt, nfa = (diag[k].cpu().numpy()
                             for k in ("rescued", "attempt", "nfa"))
    unexplained = []
    d_ok, _ = golden.nearest_segment(ref_rescued, segs[ok])
    d_any, j = golden.nearest_segment(ref_rescued, segs)
    for k in np.nonzero(d_ok > 1.0)[0]:     # beyond the coverage's 1 px
        c = j[k]
        near = d_ok[k] <= RESCUE_TOL_PX or (
            d_any[k] <= RESCUE_TOL_PX and attempt[c]
            and nfa[c] > -RESCUE_NFA_MARGIN)
        what = (f"JAX rescued {np.round(ref_rescued[k], 2).tolist()}: the "
                f"port's nearest accepted segment is {d_ok[k]:.2f} px off, "
                f"its nearest component {d_any[k]:.2f} px (tried "
                f"{bool(attempt[c])}, best log NFA {nfa[c]:.3f})")
        print(f"view {view}: {what}", flush=True)
        if not near:
            unexplained.append(what)
    mine = np.nonzero(rescued)[0]
    d_ref, _ = golden.nearest_segment(segs[mine], ref_segs)
    for k in np.nonzero(d_ref > 1.0)[0]:
        c = mine[k]
        what = (f"the port rescued {np.round(segs[c], 2).tolist()} (best "
                f"log NFA {nfa[c]:.3f}): JAX's nearest segment is "
                f"{d_ref[k]:.2f} px off")
        print(f"view {view}: {what}", flush=True)
        if d_ref[k] > RESCUE_TOL_PX and nfa[c] >= RESCUE_NFA_MARGIN:
            unexplained.append(what)
    return unexplained


def detect_rect_improve(img, dev) -> dict:
    """One detection of ``img`` with the ``rect_improve`` knob, the one
    path of K10's 4-band form, with every launch counter reset just before
    and read just after: requires the 4-band form once a round and no
    rescue form, and finite segments."""
    import torch
    from line3dpp_tpu_torch.ops import kernels, lsd

    torch.cuda.synchronize()
    kernels.reset_launches()
    stats = []
    segs = lsd.detect_batch([img], rect_improve=True, device=dev,
                            stats=stats)[0]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    rounds = len(stats[0]["rounds"])
    print(f"detection of facade view 0 with rect_improve: {len(segs)} "
          f"segments, {rounds} rounds; launches: {json.dumps(launches)}",
          flush=True)
    check(launches["band_counts"] == rounds == launches["cc_tiles"],
          "rect_improve did not run K10's 4-band form once a round")
    check(launches["rescue_counts"] == 0,
          "rect_improve alone launched K10's rescue form")
    check(len(segs) > 0 and bool(np.isfinite(segs).all()),
          "rect_improve gave no segments or non-finite ones")
    return launches


def images_to_lines(images, cams, gt, ref, dev, rescue: bool = False):
    """Detections against the reference's, then the images -> lines path
    through the user entry points with the launch counters read around
    it: under ``Config(optimize=False)``, or with ``rescue`` under
    ``Config(lsd_rescue=True)`` (rescue cascade, bundling on).  Returns the
    launches and the phase times."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import kernels, lsd
    from line3dpp_tpu_torch.utils import golden

    t0 = time.perf_counter()
    runs, states = [], []
    for image in images:
        img, _ = lsd._prepare(image, -1, dev)
        diag = {} if rescue else None
        segs_i, ok, st = lsd._lsd_core(img, rescue=rescue, diag=diag)
        runs.append((segs_i[ok].cpu().numpy().astype(np.float64), st))
        states.append((segs_i, ok, diag))
    detect_s = time.perf_counter() - t0
    ref_segs = np.split(ref["segments"], np.cumsum(ref["seg_counts"])[:-1])
    if rescue:
        ref_res = np.split(ref["rescued_segments"],
                           np.cumsum(ref["n_rescue"])[:-1])
    # Bounds: short segments of components far from the origin move by a
    # pixel or two with the order of the float32 moment sums (the fit
    # subtracts cx^2 from sxx / sw); see DETECT_* above.
    covered = total = 0.0
    for i, ((a, st), b) in enumerate(zip(runs, ref_segs)):
        cov, n_cov, n = golden.mutual_coverage(a, b)
        covered += n_cov
        total += n
        r = st["rounds"]
        print(f"view {i}: {st['used']} active pixels, components per round "
              f"{[x['components'] for x in r]}, survivors "
              f"{[x['survivors'] for x in r[:-1]]}; {len(a)} segments vs "
              f"{len(b)} of JAX, mutual 1-px endpoint coverage {cov:.4f}"
              + (f"; rescued per round {[x['n_rescue'] for x in r]}, JAX "
                 f"{int(ref['n_rescue'][i])} in all" if rescue else ""),
              flush=True)
        if rescue:
            check(abs(st["n_rescue"] - int(ref["n_rescue"][i]))
                  <= RESCUE_VIEW_DIFF,
                  f"view {i}: {st['n_rescue']} rescued rectangles, JAX "
                  f"{int(ref['n_rescue'][i])}")
            unexplained = rescue_differences(i, ref_res[i], b, *states[i])
            check(not unexplained, f"view {i}: rescued rectangles differ "
                  f"from JAX's: {unexplained}")
        check(abs(len(a) - len(b)) <= DETECT_COUNT_REL * len(b)
              and cov >= DETECT_VIEW_COVERAGE,
              f"view {i}: detections differ from the JAX reference's")
    print(f"detection of {len(images)} views: {detect_s:.3f} s; mutual "
          f"coverage over all views {covered / total:.4f}", flush=True)
    check(covered / total >= DETECT_ALL_COVERAGE,
          "the detections differ from the JAX reference's")
    if rescue:
        n_res = sum(st["n_rescue"] for _, st in runs)
        print(f"rescued rectangles over all views: {n_res} (JAX "
              f"{int(ref['n_rescue'].sum())})", flush=True)
        check(n_res > 0, "the rescue cascade rescued nothing")

    cfg = (lt.Config(lsd_rescue=True, num_neighbors=int(ref["neighbors"]))
           if rescue else
           lt.Config(optimize=False, num_neighbors=int(ref["neighbors"])))
    check(cfg.optimize == bool(ref.get("optimize", False)),
          "the reference was made with another optimize setting")
    tol = 0.01 * golden.scene_scale(gt)
    gt_lines = [gt[i:i + 1] for i in range(len(gt))]

    def gt_metrics(pred):
        sm = golden.segment_set_metrics(np.concatenate(pred), gt, tol)
        lm = golden.line_match_metrics(pred, gt_lines, tol)
        return dict(count_f1=lm["count_f1"], recall=sm["recall"],
                    precision=sm["precision"])

    # the reconstruction on the card from JAX's own detections must give
    # JAX's lines: the same segments leave only float32 rounding
    want = {k: float(ref[k]) for k in ("count_f1", "recall", "precision")}
    ref_lines = np.split(ref["lines"], np.cumsum(ref["line_counts"])[:-1])
    same = lt.Line3D(cfg)
    for i, (c, s) in enumerate(zip(cams, ref_segs)):
        same.add_view(i, c, s)
    same.match_images()
    pred = [l.segments3d for l in same.reconstruct_3d_lines()]
    f1 = golden.line_match_metrics(pred, ref_lines, tol)["count_f1"]
    got = gt_metrics(pred)
    print(f"lines from JAX's detections: {len(pred)} (JAX {len(ref_lines)}),"
          f" count_f1 against JAX's lines {f1:.4f}; against the "
          f"{len(gt)} GT lines {json.dumps(got)}", flush=True)
    check(abs(len(pred) - len(ref_lines)) <= 2
          and f1 >= (BUNDLED_SAME_F1 if cfg.optimize else 0.99)
          and all(got[k] >= want[k] - 0.02 for k in got),
          "the reconstruction from JAX's detections differs from JAX's")
    del same

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    t0 = time.perf_counter()
    pipe = lt.Line3D(cfg)
    pipe.add_images([(i, c, im) for i, (c, im) in enumerate(zip(cams,
                                                                images))])
    torch.cuda.synchronize()
    phases["add_images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.match_images()
    torch.cuda.synchronize()
    phases["match_images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = pipe.reconstruct_3d_lines()
    phases["reconstruct_3d_lines_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        base = os.path.join(tmp, cfg.filename_tag())
        pipe.save_txt(base + ".txt")
        pipe.save_stl(base + ".stl")
        pipe.save_obj(base + ".obj")
        phases["save_s"] = time.perf_counter() - t0
        with open(base + ".txt") as f:
            n_rows = sum(1 for _ in f)
    launches = dict(kernels.LAUNCHES)
    phases["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    print("images -> lines: " + json.dumps(phases), flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    for name, n in launches.items():
        # K5 and K6's gather_labels form are not on the detection path
        # (held against their plain versions above); K10 and K9's
        # gate_pixels form run in the rescue cascade only
        check(n > 0 or name in OFF_PATH
              or (name in RESCUE_ONLY and not rescue)
              or (name in BUNDLE_ONLY and not cfg.optimize)
              or (name in COLLINEAR_ONLY and not cfg.collinearity_t > 0),
              f"kernel {name} was not launched on the images -> lines path")
    check(all(launches[name] == 0 for name in OFF_PATH),
          "detection launched K5 or K6's gather_labels form")
    check(launches["gather_merged"] == launches["cc_tiles"],
          "K6 with the map did not run once per detection round")
    if rescue:
        got_res = [st["n_rescue"] for st in pipe.detect_stats]
        check(got_res == [st["n_rescue"] for _, st in runs],
              "add_images rescued other rectangles than the detection pass")
    check(n_rows == len(lines), "TXT rows != line count")
    check(all(np.isfinite(l.segments3d).all() for l in lines),
          "non-finite 3D segments")

    # From the port's own detections the GT metrics move as far as the
    # detections move with the order of the moment sums: GT_SPREAD above.
    pred = [l.segments3d for l in lines]
    got = gt_metrics(pred)
    f1 = golden.line_match_metrics(pred, ref_lines, tol)["count_f1"]
    print(f"result: {len(lines)} lines (JAX {len(ref_lines)}, count_f1 "
          f"against them {f1:.4f}) vs {len(gt)} GT lines: "
          f"{json.dumps(got)}; JAX on the CPU: {json.dumps(want)}",
          flush=True)
    for k in got:
        check(got[k] >= want[k] - GT_SPREAD, f"{k} {got[k]:.4f} is more "
              f"than {GT_SPREAD} below the JAX package's {want[k]:.4f}")
    return launches, dict(phases, detect_s=detect_s), pipe


def quaternion(R) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix near the identity (trace form)."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def facade_worldpoints(cams, gt) -> tuple[list, list]:
    """Points along the facade's GT lines and, per view, the ids of those
    it sees (in front of it and inside the image): ``(points, tracks)``
    with ``tracks[i]`` a list of ``(point id, u, v)``."""
    ts = np.linspace(0.1, 0.9, NVM_POINTS_PER_LINE)
    pts = np.concatenate([g[:3] + ts[:, None] * (g[3:] - g[:3]) for g in gt])
    tracks = []
    for cam in cams:
        z = (pts @ cam.R.T + cam.t)[:, 2]
        uv = cam.project(pts)
        ok = ((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        tracks.append([(j, *uv[j]) for j in np.flatnonzero(ok)])
    return pts, tracks


def write_nvm(path, names, cams, pts, tracks) -> None:
    """An NVM_V3 file of the posed views (fx = fy, principal point at the
    centre, no distortion; quaternion and centre as ``repr`` floats) and
    their worldpoints."""
    rows = ["NVM_V3", "", str(len(cams))]
    for name, cam in zip(names, cams):
        q = quaternion(cam.R)
        rows.append(" ".join([name, repr(float(cam.K[0, 0]))]
                             + [repr(float(x)) for x in (*q, *cam.C)]
                             + ["0", "0"]))
    obs: list[list] = [[] for _ in pts]
    for i, tr in enumerate(tracks):
        for j, u, v in tr:
            obs[j].append(f"{i} {j} {float(u)!r} {float(v)!r}")
    rows += ["", str(len(pts))]
    rows += [" ".join(repr(float(x)) for x in X) + f" 255 255 255 {len(o)} "
             + " ".join(o) for X, o in zip(pts, obs)]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def cli_phase(images, cams, gt, ref, seg_views, geo_lines, dev) -> dict:
    """The command line at full width: the facade views as binary PGM and
    their poses (and worldpoints along the GT lines) as an NVM, through
    ``line3dpp_tpu_torch.cli.run.main(["vsfm", ...])`` on the card, twice
    on one output folder.  The first run must detect exactly the
    segments of the images -> lines phase (``seg_views``) and give the
    lines of an in-process ``Line3D`` fed those segments with the same
    worldpoints; the second must load the segment cache the first wrote,
    detect nothing and write the same TXT.  Returns the phases."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.cli.run import main as cli_main
    from line3dpp_tpu_torch.ops import kernels
    from line3dpp_tpu_torch.utils import golden
    from line3dpp_tpu_torch.utils.images import write_pgm

    N = int(ref["neighbors"])
    cfg = lt.Config(optimize=False, num_neighbors=N)
    pts, tracks = facade_worldpoints(cams, gt)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        names = [f"view{i:02d}.pgm" for i in range(len(images))]
        for name, im in zip(names, images):
            write_pgm(os.path.join(tmp, name), im)
        nvm = os.path.join(tmp, "result.nvm")
        write_nvm(nvm, names, cams, pts, tracks)
        out["write_inputs_s"] = time.perf_counter() - t0
        argv = ["vsfm", "-i", tmp, "-m", nvm, "-o",
                os.path.join(tmp, "out"), "--no-optimize", "-n", str(N)]
        runs, launches, txts = [], [], []
        for _ in range(2):
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run = cli_main(argv)
            phases = dict(run.phases, wall_s=time.perf_counter() - t0,
                          peak_device_GiB=torch.cuda.max_memory_allocated()
                          / 2**30)
            launches.append(dict(kernels.LAUNCHES))
            with open(run.base + ".txt", "rb") as f:
                txts.append(f.read())
            runs.append(run)
            print("CLI run: " + json.dumps(phases), flush=True)
            print("CLI launches: " + json.dumps(launches[-1]), flush=True)
            out[f"run{len(runs)}"] = phases
    first, second = runs
    check(first.pipe.config == cfg, "the CLI built another Config")
    check(first.pipe.device.type == "cuda", "the CLI did not run on the card")
    check(all(n > 0 for k, n in launches[0].items()
              if k not in OFF_PATH + RESCUE_ONLY
              and (cfg.optimize or k not in BUNDLE_ONLY)
              and (cfg.collinearity_t > 0 or k not in COLLINEAR_ONLY)),
          "the CLI's first run did not launch every kernel of its path")
    check(len(first.pipe.detect_stats) == len(images),
          "the CLI's first run did not detect every view")
    check(all(np.array_equal(first.pipe._views[i].segments, seg_views[i])
              for i in range(len(images))),
          "the CLI's detections differ from the images -> lines phase's")
    check(all(len(e.worldpoints) > 0 for e in first.pipe._views.values()),
          "a view of the CLI carries no worldpoints")
    check(second.pipe.detect_stats == []
          and launches[1]["cc_tiles"] == 0,
          "the CLI's second run detected instead of loading its cache")
    check(txts[1] == txts[0], "the CLI's second run wrote another TXT")

    # the same segments and worldpoints in process, with the original
    # poses: the CLI differs only by the NVM's pose round trip
    twin = lt.Line3D(cfg)
    for i, cam in enumerate(cams):
        twin.add_view(i, cam, seg_views[i], [t[0] for t in tracks[i]])
    twin.match_images()
    want = [l.segments3d for l in twin.reconstruct_3d_lines()]
    got = [l.segments3d for l in first.pipe.lines3d]
    n_rows = len(txts[0].decode().strip().splitlines())
    check(n_rows == len(got), "the CLI's TXT rows != its line count")
    tol = 0.01 * golden.scene_scale(gt)
    f1 = golden.line_match_metrics(got, want, tol)["count_f1"]
    gt_lines = [gt[i:i + 1] for i in range(len(gt))]

    def gt_metrics(pred):
        sm = golden.segment_set_metrics(np.concatenate(pred), gt, tol)
        return dict(count_f1=golden.line_match_metrics(pred, gt_lines,
                                                       tol)["count_f1"],
                    recall=sm["recall"], precision=sm["precision"])

    got_gt, geo_gt = gt_metrics(got), gt_metrics(geo_lines)
    print(f"CLI: {len(got)} lines, the in-process twin {len(want)} "
          f"(count_f1 {f1:.4f}); {sum(len(t) for t in tracks)} "
          f"observations of {len(pts)} worldpoints; against the "
          f"{len(gt)} GT lines {json.dumps(got_gt)}, the images -> lines "
          f"phase (geometric neighbours) {json.dumps(geo_gt)}", flush=True)
    check(abs(len(got) - len(want)) <= max(1, SAME_COUNT_REL * len(want))
          and f1 >= SAME_F1,
          "the CLI's lines differ from the in-process pipeline's")
    for k in got_gt:
        check(got_gt[k] >= geo_gt[k] - GT_SPREAD,
              f"the CLI's {k} {got_gt[k]:.4f} is more than {GT_SPREAD} "
              f"below the images -> lines phase's {geo_gt[k]:.4f}")
    out.update(lines=len(got), count_f1_twin=f1, gt=got_gt)
    return out


def held_lines(pred, ref_lines, what: str, min_f1: float = SAME_F1) -> float:
    """Lines against a JAX reference from the same segments: the count
    within ``SAME_COUNT_REL`` (at least one line) and count_f1 >=
    ``min_f1`` at 1% of the reference's scene scale; returns count_f1."""
    from line3dpp_tpu_torch.utils import golden

    tol = 0.01 * golden.scene_scale(np.concatenate(ref_lines))
    f1 = golden.line_match_metrics(pred, ref_lines, tol)["count_f1"]
    print(f"{what}: {len(pred)} lines (JAX {len(ref_lines)}), count_f1 "
          f"{f1:.5f}", flush=True)
    check(abs(len(pred) - len(ref_lines))
          <= max(1, SAME_COUNT_REL * len(ref_lines)) and f1 >= min_f1,
          f"{what}: the lines differ from the JAX reference's")
    check(all(np.isfinite(p).all() for p in pred), f"{what}: non-finite")
    return f1


def split_lines(data, prefix: str = "") -> list:
    return np.split(data[prefix + "lines"],
                    np.cumsum(data[prefix + "line_counts"])[:-1])


def timed_pipeline(pipe) -> dict:
    """match_images and reconstruct_3d_lines of ``pipe`` with the launch
    counters reset before and read after, and their wall times."""
    import torch
    from line3dpp_tpu_torch.ops import kernels

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.match_images()
    torch.cuda.synchronize()
    phases = {"match_images_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    pipe.reconstruct_3d_lines()
    torch.cuda.synchronize()
    phases["reconstruct_3d_lines_s"] = time.perf_counter() - t0
    phases["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    for name in ("match_pairs", "score_matches", "gather_target_estimates"):
        check(kernels.LAUNCHES[name] > 0, f"kernel {name} was not launched")
    return phases


def colmap_phase(dev) -> dict:
    """The worldpoint-overlap neighbours end to end: the COLMAP model of
    the 26 views (``read_colmap``) and their cached segments through
    ``add_view(worldpoints=...)``, ``Config(optimize=False)``, against
    ``tests/data/torch_colmap_26_jax_reference.npz``."""
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.utils.testdata import load_colmap_views

    if not os.path.exists(COLMAP_NPZ):
        fail(f"missing {COLMAP_NPZ} (tests/make_torch_colmap_reference.py)")
    with np.load(COLMAP_NPZ) as data:
        ref = {k: data[k] for k in data.files}
    t0 = time.perf_counter()
    views = load_colmap_views()
    read_s = time.perf_counter() - t0
    pipe = lt.Line3D(lt.Config(optimize=False))
    for cam_id, v, segs in views:
        pipe.add_view(cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height,
                                        median_depth=v.median_depth),
                      segs, worldpoints=v.worldpoints)
    check(len(pipe._views) == 26
          and all(e.worldpoints for e in pipe._views.values()),
          "a COLMAP view carries no worldpoints: the geometric fallback "
          "would run")
    phases = dict(read_colmap_and_cache_s=read_s, **timed_pipeline(pipe))
    nbr = pipe._last_state["neighbor_ids"]
    check(np.array_equal(nbr, ref["neighbor_ids"]),
          "the worldpoint neighbours differ from JAX's")
    phases["count_f1"] = held_lines(
        [l.segments3d for l in pipe.lines3d], split_lines(ref),
        "COLMAP worldpoint neighbours, 26 views")
    print("COLMAP worldpoints: " + json.dumps(phases), flush=True)
    return phases


def features_phase(dev) -> dict:
    """Item 13 against ``tests/data/torch_features_jax_reference.npz``:
    each configuration there (the reference's options ``perform_rdd`` and
    ``collinearity_t``; the repository's compensations) on the 26 cached
    views; the collinearity and RDD calls of the first are then profiled
    again on the inputs the pipeline gave them, and its reconstruction
    once more, for the device events and launches inside
    ``recon.collinearity``."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import collinearity, kernels, rdd
    from line3dpp_tpu_torch.utils.testdata import load_views

    if not os.path.exists(FEATURES_NPZ):
        fail(f"missing {FEATURES_NPZ} "
             f"(tests/make_torch_features_reference.py)")
    calls = {}

    def capture(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            calls[name] = (orig, args, kw)
            return orig(*args, **kw)
        setattr(mod, name, wrapped)
        return mod, name, orig

    origs = [capture(collinearity, "collinear_edges"),
             capture(rdd, "rdd_edges")]
    out = {}
    try:
        with np.load(FEATURES_NPZ) as data:
            ref = {k: data[k] for k in data.files}
        for name in ("reference", "compensations"):
            ids = [int(i) for i in ref[f"{name}_views"]]
            kw = json.loads(str(ref[f"{name}_config"]))
            pipe = lt.Line3D(lt.Config(**kw))
            for v in load_views(ids):
                pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width,
                                                  v.height), v.segments)
            calls.clear()
            phases = timed_pipeline(pipe)
            phases["launches"] = {k: kernels.LAUNCHES[k] for k in (
                "match_pairs", "score_matches", "gather_target_estimates",
                "collinear_edges")}
            phases["count_f1"] = held_lines(
                [l.segments3d for l in pipe.lines3d],
                split_lines(ref, name + "_"),
                f"item 13, {name} options {kw}, {len(ids)} views")
            want = {"collinear_edges", "rdd_edges"} if kw.get(
                "perform_rdd") else set()
            check(set(calls) == want, f"item 13, {name}: the pipeline "
                  f"called {sorted(calls)}, not {sorted(want)}")
            for fname, (fn, args, fkw) in calls.items():
                _, events, wall = device_events(lambda: fn(*args, **fkw))
                busy, n_dev = device_busy_us(events)
                phases[fname] = dict(
                    wall_ms=1e3 * wall, device_ms=busy / 1e3,
                    device_events=n_dev, d2h=sum(
                        1 for e in events if e.get("cat") == "gpu_memcpy"
                        and "DtoH" in e.get("name", "")))
            n_cl = int("collinear_edges" in calls)
            check(phases["launches"]["collinear_edges"] == n_cl,
                  f"item 13, {name}: the pipeline launched the collinearity "
                  f"kernel {phases['launches']['collinear_edges']} times, "
                  f"not {n_cl}")
            if "rdd_edges" in calls:
                args = calls["rdd_edges"][1]
                phases["rdd_graph"] = dict(nodes=int(args[3]),
                                           edges=int(len(args[0])))
                e = calls["collinear_edges"][1]
                phases["collinear_edges"]["edges"] = int(len(
                    calls["collinear_edges"][0](*e)[0]))
                # the pipeline's own collinearity call, profiled in a
                # second reconstruct_3d_lines of the same matches
                kernels.reset_launches()
                _, events, _ = device_events(pipe.reconstruct_3d_lines)
                n_dev, d2h = span_device_events(events, "recon.collinearity")
                cl = phases["recon.collinearity"] = dict(
                    device_events=n_dev, d2h=d2h,
                    launches=kernels.LAUNCHES["collinear_edges"])
                check(cl["launches"] == 1, f"item 13, {name}: a profiled "
                      f"reconstruct_3d_lines launched the collinearity "
                      f"kernel {cl['launches']} times, not once")
                check(n_dev <= 8 and d2h <= 2,
                      f"item 13, {name}: recon.collinearity made {n_dev} "
                      f"device events and {d2h} device-to-host copies in "
                      f"the pipeline's run (at most 8 and 2)")
                if "kernel_row" not in out:
                    out["kernel_row"] = collinearity_row(e)
                    # the main path's count: the pipeline's run above
                    out["kernel_row"]["pipeline_launches"] = \
                        phases["launches"]["collinear_edges"]
            out[name] = phases
            print(f"item 13, {name}: " + json.dumps(phases), flush=True)
            del pipe
            torch.cuda.empty_cache()
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)
    return out

def collinear_pretest_threshold(lc, t_px):
    """The collinearity kernel's pre-test threshold of a row segment of
    clamped length ``lc`` (a float32 tensor): ``fl(fl(lc t) *
    CL_PRETEST_MARGIN)``, +inf where ``fl(lc t)`` is not a normal float (or
    NaN)."""
    import torch

    f32 = torch.float32
    tl = lc * t_px
    return torch.where(tl >= torch.tensor(CL_PRETEST_TINY, dtype=f32),
                       tl * torch.tensor(CL_PRETEST_MARGIN, dtype=f32),
                       torch.tensor(float("inf"), dtype=f32))


def collinear_pretest_keeps(segments, mask, t_px):
    """(B, S, S) bool: the collinearity kernel's pre-test of the pairs of B
    views in float32 torch, the same operations in the same order.  Row i
    keeps column j while both of j's endpoints lie within the threshold of
    i's line by the distance's numerator (the exact test's own), and both
    are masked in; False only where ``collinearity.collinear_pairs`` is
    False too.  ``t_px`` is a float or a float32 tensor of the grid's
    shape (a threshold for each pair)."""
    import torch
    from line3dpp_tpu_torch.ops import collinearity as cl

    x1, y1, x2, y2 = segments.unbind(-1)
    a = lambda t: t[:, :, None]            # noqa: E731  row segment i
    b = lambda t: t[:, None, :]            # noqa: E731  column segment j
    dx = x2 - x1
    dy = y2 - y1
    thr = collinear_pretest_threshold(
        a(torch.clamp_min(cl._sqrt(dx * dx + dy * dy), cl.EPS)), t_px)

    def num(px, py):
        return torch.abs(a(dy) * px - a(dx) * py + a(x2 * y1) - a(y2 * x1))

    return ((num(b(x1), b(y1)) <= thr) & (num(b(x2), b(y2)) <= thr)
            & a(mask) & b(mask))


def same_edges(a, b) -> bool:
    """Two ``collinear_edges`` results: the same keys in the same order and
    the same weight bits."""
    return (all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
            and np.array_equal(a[3].view(np.int32), b[3].view(np.int32)))


def collinearity_row(args) -> dict:
    """The kernels line's row of the collinearity kernel on the inputs the
    pipeline gave ``collinear_edges`` (the 26 cached views under the
    reference's options): its edges against the plain path's on the card
    (keys, order and weight bits), its card time by the count pass, the
    scan and the write pass queued without the wrapper's two reads, its
    bound from the work these inputs need (``CL_OPS_*``: the pre-test for
    every pair of eligible segments, the exact 2D test for its survivors,
    the similarity for the 2D pairs), and the plain path's time."""
    import torch
    from line3dpp_tpu_torch.ops import collinearity as cl
    from line3dpp_tpu_torch.ops import kernels

    (segs, mask, P1, P2, d1, d2, valid, k_reg, med, med_scene, t_px,
     min_aff) = args
    got = cl.collinear_edges_cuda(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cl.collinear_edges_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(same_edges(got, want), "the collinearity kernel's edges differ "
                                 "from the plain path's")
    check(same_edges(got, cl.collinear_edges_cuda(*args)),
          "two calls of the collinearity kernel differ")

    # the work these inputs need
    V, S = mask.shape
    ok = mask & valid
    n = ok.sum(1).double()
    eligible = float((n * (n - 1) / 2).sum())
    upper = torch.ones((S, S), dtype=torch.bool, device=segs.device).triu_(1)
    survivors = pairs2d = 0
    for v in range(V):
        sl = slice(v, v + 1)
        survivors += int((collinear_pretest_keeps(segs[sl], ok[sl], t_px)
                          & upper).sum())
        pairs2d += int((cl.collinear_pairs(segs[sl], ok[sl], t_px)
                        & upper).sum())
    ops = (eligible * CL_OPS_PRETEST + survivors * CL_OPS_EXACT
           + pairs2d * CL_OPS_SIMILARITY)
    every_pair = V * S * (S - 1) / 2 * CL_OPS_EXACT
    moved = nbytes(segs, mask, P1, P2, d1, d2, valid, k_reg, med) \
        + 16 * len(got[0])

    # the launches alone, into buffers of the known size
    dev = segs.device
    cut = (torch.clamp_max(med, med_scene) if med_scene > cl.EPS else med)
    T = -(-S // cl.TILE)
    counts = torch.empty((V, S, T), dtype=torch.int64, device=dev)
    out = torch.empty((len(got[0]), 4), dtype=torch.int32, device=dev)
    inputs = [kernels.ptr(x) for x in (segs, mask, P1, P2, d1, d2, valid,
                                       k_reg, cut)]
    opts = (V, S, T, float(t_px), float(min_aff))

    def count():
        kernels.launch("l3d_collinear_count", *inputs, *opts,
                       kernels.ptr(counts), kernels.stream(dev))

    def card():
        count()
        ends = cl.piece_ends(counts)
        kernels.launch("l3d_collinear_write", *inputs, *opts,
                       kernels.ptr(counts), kernels.ptr(ends),
                       kernels.ptr(out), kernels.stream(dev))

    row = kernel_row(
        "CL collinear_edges", "collinearity.cu",
        "none (line3dpp_tpu/ops/collinearity.py collinear_pairs and "
        "collinear_similarity: jnp under XLA)", 0.0,
        lambda: cl.collinear_edges_cuda(*args), plain_ms, ops, moved,
        card=card)
    row.update(edges=int(len(got[0])), views=V, segments=S,
               eligible_pairs=eligible, pretest_survivors=survivors,
               pairs_2d=pairs2d, ops=ops, bytes=moved,
               count_device_ms=device_ms(count),
               every_pair_bound_ms=bound(every_pair, moved)[0])
    print(f"[CL] collinear_edges on {V} views of {S} segments: {row['edges']}"
          f" edges, bit-equal to the plain path; wrapper {row['ms']:.4f} ms,"
          f" card {row['device_ms']:.4f} ms (count pass "
          f"{row['count_device_ms']:.4f}), bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}: {eligible:.4g} eligible pairs, {survivors} "
          f"pre-test survivors, {pairs2d} 2D pairs; every pair exact "
          f"{row['every_pair_bound_ms']:.4f} ms), plain path {plain_ms:.1f} "
          f"ms", flush=True)
    return row


def lm_reference(dev):
    """The bundling reference file: the Levenberg-Marquardt problem the JAX
    package assembled on the 26 cached views as tensors on ``dev`` (the
    port's ``problem_from_capture`` of the stored arrays), and the file."""
    from line3dpp_tpu_torch.ops import bundling

    if not os.path.exists(BUNDLING_NPZ):
        fail(f"missing {BUNDLING_NPZ} "
             f"(tests/make_torch_bundling_reference.py)")
    with np.load(BUNDLING_NPZ) as data:
        ref = {k: data[k] for k in data.files}
    return bundling.problem_from_reference(ref, dev), ref


def lm_row(prob, args, iters: int, runs, lm) -> dict:
    """The kernels line's row of the bundling kernel on JAX's problem:
    its final cost against the plain loop's on the card, its bound from
    the work these inputs need (each cluster's Jacobians at the start and
    after each accepted step, a cost per iteration and one at the start),
    and the plain loop's time."""
    import torch
    from line3dpp_tpu_torch.ops import bundling

    C = prob["C"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bundling.lm_optimize_plain(*args, num_clusters=C,
                                       iterations=iters)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got = float(bundling.lm_cost(runs[0][0], *args[1:],
                                 num_clusters=C).double().sum())
    want = float(bundling.lm_cost(plain, *args[1:],
                                  num_clusters=C).double().sum())
    rel = abs(got - want) / want
    n = torch.bincount(args[1].long(), minlength=C).double().cpu().numpy()
    acc = lm["accepted"].double().cpu().numpy()
    ops = float(np.sum((1 + acc) * (LM_OPS_PER_JACOBIAN * n
                                     + LM_OPS_PER_FRAME)
                       + (iters + 1) * LM_OPS_PER_COST * n
                       + iters * LM_OPS_PER_STEP))
    moved = nbytes(*args) + 8 * len(n) + 4 * (len(n) + 1) + nbytes(
        runs[0][0], lm["accepted"])
    fn = lambda: bundling.lm_optimize(*args, num_clusters=C,
                                      iterations=iters)
    row = kernel_row("LM lm_bundle", "bundling.cu",
                     "none (line3dpp_tpu/ops/bundling.py:157 lm_optimize, "
                     "XLA-jitted)", rel, fn, plain_ms, ops, moved)
    row.update(clusters=C, observations=int(n.sum()), iterations=iters,
               accepted_steps=int(acc.sum()), ops=ops, bytes=moved)
    print(f"[LM] lm_bundle, {iters} iterations on {C} clusters: wrapper "
          f"{row['ms']:.4f} ms, card {row['device_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {ops:.4g} "
          f"operations, {moved} bytes), plain loop {plain_ms:.1f} ms; "
          f"total cost against the plain loop's rel {rel:.2e} (limit "
          f"{LM_PLAIN_RTOL}); accepted steps {int(acc.sum())}", flush=True)
    check(rel <= LM_PLAIN_RTOL,
          "the bundling kernel ends at another cost than the plain loop")
    return row


def bundled_cached(views, dev, opts):
    """The 26 cached views under the default ``Config()``: the port's LM on
    JAX's problem against JAX's costs, then the bundled path through the
    user entry points against JAX's bundled lines.  Returns the kernels
    line's row of the bundling kernel."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import bundling, kernels
    from line3dpp_tpu_torch.utils import golden

    prob, ref = lm_reference(dev)
    C, iters = prob["C"], int(ref["iterations"])
    args = [prob[k] for k in bundling.LM_ARRAYS]
    cost0 = bundling.lm_cost(*args, num_clusters=C)
    want0, want = float(ref["cost0"].sum()), float(ref["cost"].sum())
    rel0 = abs(float(cost0.sum()) - want0) / want0
    print(f"LM problem of JAX: {C} clusters, {args[1].numel()} observations; "
          f"total cost at the start {float(cost0.sum()):.3f} (JAX "
          f"{want0:.3f}, rel {rel0:.2e}, limit {LM_COST0_RTOL})", flush=True)
    check(rel0 <= LM_COST0_RTOL, "lm_cost differs from JAX's at the start")
    runs, lm = [], [{}, {}]
    for k in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = bundling.lm_optimize(*args, num_clusters=C,
                                      iterations=iters, stats=lm[k])
        torch.cuda.synchronize()
        runs.append((params, time.perf_counter() - t0))
    cost = bundling.lm_cost(runs[0][0], *args[1:], num_clusters=C)
    rel = abs(float(cost.sum()) - want) / want
    same = (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(lm[0]["accepted"], lm[1]["accepted"]))
    per = (cost.cpu().numpy() - ref["cost"]) / np.maximum(ref["cost"], 1e-6)
    print(f"lm_optimize, {iters} iterations: {runs[0][1]:.3f} s and "
          f"{runs[1][1]:.3f} s; total cost {float(cost.sum()):.3f} (JAX "
          f"{want:.3f}, rel {rel:.2e}, limit {LM_COST_RTOL}); clusters more "
          f"than 1% above JAX's cost: {int((per > 0.01).sum())}, below: "
          f"{int((per < -0.01).sum())}; two runs bit-identical: {same}",
          flush=True)
    check(bool(torch.isfinite(runs[0][0]).all()), "non-finite LM parameters")
    check(rel <= LM_COST_RTOL, "lm_optimize ends at another cost than JAX's")
    check(same, "two lm_optimize runs on the card differ")
    check(lm[0]["launches"] == 1, "lm_optimize launched no kernel")
    row = lm_row(prob, args, iters, runs, lm[0])
    if opts.profile:
        profile(lambda: bundling.lm_optimize(*args, num_clusters=C,
                                             iterations=25),
                "lm_optimize_25_iterations", opts.out)

    cfg = lt.Config()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    t0 = time.perf_counter()
    pipe = lt.Line3D(cfg)
    for v in views:
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    pipe.match_images()
    torch.cuda.synchronize()
    phases["add_view_and_match_images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = pipe.reconstruct_3d_lines()
    phases["reconstruct_3d_lines_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, cfg.filename_tag())
        pipe.save_txt(base + ".txt")
        pipe.save_stl(base + ".stl")
        pipe.save_obj(base + ".obj")
        with open(base + ".txt") as f:
            n_rows = sum(1 for _ in f)
    launches = dict(kernels.LAUNCHES)
    phases["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    print("cached segments -> bundled lines: " + json.dumps(phases),
          flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    for name in ("match_pairs", "score_matches", "gather_target_estimates"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the bundled path")
    check(n_rows == len(lines), "TXT rows != line count")
    check(all(np.isfinite(l.segments3d).all() for l in lines),
          "non-finite 3D segments")
    pred = [l.segments3d for l in lines]
    ref_lines = np.split(ref["lines"].astype(np.float64),
                         np.cumsum(ref["line_counts"])[:-1])
    scale = golden.scene_scale(ref["lines"].astype(np.float64))
    f1 = {t: golden.line_match_metrics(pred, ref_lines, t * scale)[
        "count_f1"] for t in (1e-2, 1e-3)}
    print(f"result: {len(lines)} bundled lines (JAX {len(ref_lines)}); "
          f"count_f1 against JAX's bundled lines at 1% / 0.1% scene scale "
          f"{f1[1e-2]:.4f} / {f1[1e-3]:.4f}", flush=True)
    check(abs(len(lines) - len(ref_lines)) <= 0.01 * len(ref_lines),
          "bundled line count off JAX's by more than 1%")
    check(f1[1e-2] >= 0.99, "bundled lines: count_f1 < 0.99 against JAX's")
    check(launches["lm_bundle"] == 1 and pipe.bundle_stats["launches"] == 1,
          "the bundled path did not bundle in one kernel launch")
    print("bundle_stats: " + json.dumps(pipe.bundle_stats), flush=True)
    return row


def check_bin_round_trip(pipe, base: str) -> float:
    """``Line3D.save_bin`` in both formats, then ``load_bin``: the lines
    back (the boost format keeps each residual's (camID, segID) only).
    Returns the seconds of the two writes."""
    import line3dpp_tpu_torch as lt

    t0 = time.perf_counter()
    pipe.save_bin(base + ".bin")
    pipe.save_bin(base + "_npz.bin", fmt="npz")
    save_s = time.perf_counter() - t0
    for path, cols in ((base + ".bin", 2), (base + "_npz.bin", 6)):
        back = lt.load_bin(path)
        same = len(back) == len(pipe.lines3d) and all(
            np.array_equal(a.segments3d, b.segments3d)
            and np.array_equal(a.residuals[:, :cols], b.residuals[:, :cols])
            for a, b in zip(back, pipe.lines3d))
        print(f"save_bin / load_bin {os.path.basename(path)}: "
              f"{os.path.getsize(path)} bytes, {len(back)} lines back, "
              f"equal to lines3d: {same}", flush=True)
        check(same, f"{path}: load_bin did not give back lines3d")
    return save_s


# Brown coefficients (k1, k2, k3, p1, p2) of the undistortion check
UNDISTORT_COEFFS = (-0.12, 0.03, 0.0, 0.0015, -0.0008)


def check_undistort(image, K, dev) -> dict:
    """``undistort_image`` of a full-size image on the card against the
    port's CPU result on the same float32 image (the same float32
    operations: atol 0.02 on the 0-255 range), timed by CUDA events with
    the copies to and from the card."""
    import line3dpp_tpu_torch as lt

    img = np.asarray(image, np.float32)
    dist = np.array(UNDISTORT_COEFFS)
    got = lt.undistort_image(img, K, dist, device=dev)
    want = lt.undistort_image(img, K, dist, device="cpu")
    err = float(np.abs(got - want).max())
    t0 = time.perf_counter()
    lt.undistort_image(img, K, dist, device="cpu")
    cpu_s = time.perf_counter() - t0
    row = dict(shape=list(img.shape), max_abs_err=err,
               outside=int((got == 0).sum()),
               ms=cuda_ms(lambda: lt.undistort_image(img, K, dist,
                                                     device=dev), 5),
               cpu_ms=1e3 * cpu_s)
    print(f"undistort_image on the card: {json.dumps(row)}", flush=True)
    check(got.shape == img.shape and np.isfinite(got).all() and err <= 0.02,
          "undistort_image on the card differs from the CPU's")
    return row


def pair_subset(t, lo: int, hi: int):
    """The pair tables ``t`` restricted to pairs [lo, hi) (the view tables
    whole)."""
    cut = lambda x: x[lo:hi].contiguous()
    return t._replace(e1=cut(t.e1), e2=cut(t.e2), num_src=cut(t.num_src),
                      num_tgt=cut(t.num_tgt), src_idx=cut(t.src_idx),
                      tgt_idx=cut(t.tgt_idx), pair_valid=cut(t.pair_valid))


def same_matches(got, want, what: str) -> None:
    """Two K1 outputs equal in every field, bit for bit."""
    import torch

    bad = [f for f in got._fields
           if not torch.equal(getattr(got, f), getattr(want, f))]
    print(f"{what}: {int(want.valid.sum())} valid slots; fields that differ: "
          f"{bad}", flush=True)
    check(not bad, f"{what}: differs in {bad}")


def k1_candidates(t) -> int:
    n_src = (t.mask[t.src_idx.long()] & t.pair_valid[:, None]).sum(1)
    n_tgt = t.mask[t.tgt_idx.long()].sum(1)
    return int((n_src * n_tgt).sum())


def block_k2_args(inp, d, pm, lo: int, hi: int):
    """Kernel K2's arguments for source views [lo, hi) from K1's table
    ``pm`` of their pairs, the target cameras from the whole scene's
    tables (``_match_score_filter``'s)."""
    from line3dpp_tpu_torch.models import step

    nbr = d["neighbor_ids"][lo:hi]
    Vb, N = nbr.shape
    rays = step.hypothesis_rays(d["segments"][lo:hi], d["RtKinv"][lo:hi])
    n = nbr.long()
    return (*(r.contiguous() for r in rays), d["C"][lo:hi].contiguous(),
            d["k_reg"][lo:hi].contiguous(), d["C"][n].contiguous(),
            d["k_reg"][n].contiguous(),
            *(step.regroup(x, Vb, N).contiguous()
              for x in (pm.d_p1, pm.d_p2, pm.valid)))


def sparse_pretest_counts(args, kw, chunk: int = 32) -> dict:
    """Kernel K2's work on a table too wide for :func:`pretest_counts`'
    (chunk, M, M) planes: per segment, its valid slots after the gate
    (the kernel's records) and, over their pairs of different groups,
    those the pre-test keeps (the survivors), counted in torch one segment
    at a time."""
    import torch
    from line3dpp_tpu_torch.ops import scoring

    r1, r2, rmid, C, k_reg, tgt_C, tgt_k, d_p1, d_p2, valid = args
    V, S, M = d_p1.shape
    knn = kw["knn"]
    flat = lambda x: x.reshape(V * S, *x.shape[2:])
    view_of = torch.arange(V, device=d_p1.device).repeat_interleave(S)
    fr = [flat(a) for a in (r1, r2, rmid, d_p1, d_p2, valid)]
    n = dict(segments=V * S, valid_slots=0, gated_slots=0, pairs=0,
             survivors=0, max_gated_slots=0)
    per_seg = []
    for lo in range(0, V * S, chunk):
        sl = slice(lo, min(lo + chunk, V * S))
        vv = view_of[sl]
        a1, a2, am, d1, d2, mv = (a[sl] for a in fr)
        n["valid_slots"] += int(mv.sum())
        dirc, ok, den1, den2 = scoring._slot_geometry(
            a1, a2, am, d1, d2, mv, C[vv], k_reg[vv], tgt_C[vv], tgt_k[vv],
            knn=knn, check_orientation=kw["check_orientation"])
        for b in range(ok.shape[0]):
            idx = torch.nonzero(ok[b]).reshape(-1)
            m = int(idx.numel())
            per_seg.append(m)
            if m < 2:
                continue
            g = idx // knn
            dv = [c[b, idx] for c in dirc]
            e1 = d1[b, idx][:, None] - d1[b, idx][None, :]
            e2 = d2[b, idx][:, None] - d2[b, idx][None, :]
            dot = (dv[0][:, None] * dv[0][None, :] + dv[1][:, None]
                   * dv[1][None, :] + dv[2][:, None] * dv[2][None, :])
            other = g[:, None] != g[None, :]
            keep = other & scoring.pretest_keeps_plain(
                dot, e1, e2, den1[b, idx], den2[b, idx], kw["two_sig_a_sqr"],
                kw["min_similarity"])
            n["pairs"] += int(other.sum())
            n["survivors"] += int(keep.sum())
    per_seg = np.array(per_seg)
    n["gated_slots"] = int(per_seg.sum())
    n["max_gated_slots"] = int(per_seg.max())
    n["mean_gated_slots"] = float(per_seg.mean())
    n["median_gated_slots"] = float(np.median(per_seg))
    n["segments_with_slots"] = int((per_seg > 0).sum())
    return n


def wide_kernel_checks(inp, cfg, dev) -> tuple[list, dict]:
    """K1 and K2 past the cells' k and M on the 26 views: K1 at k = 20
    (416 pairs, a kernels-line row of its own) and at k = S (the 48 pairs
    of views 0-2, one all-matches block) against the plain matcher, with
    the rows past its list (``matching.LIST_LEN``: the overflow path)
    counted; K2 against the plain scorer at knn = 100 (M = 1600, views
    0-2); K2's time on the all-matches block (M = 48,000) with the counts
    behind its bound and the segments past its records
    (``scoring.RECORDS``)."""
    import torch
    from line3dpp_tpu_torch.ops import matching, scoring

    d = {n: torch.from_numpy(inp[n]).to(dev) for n in (
        "segments", "seg_mask", "RtKinv", "C", "k_reg", "neighbor_ids", "F",
        "pair_valid")}
    V, N = d["neighbor_ids"].shape
    S = d["seg_mask"].shape[1]
    eo = cfg.epipolar_overlap
    src = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(N)
    t = matching.pair_tables(d["segments"], d["seg_mask"], d["RtKinv"],
                             d["C"], src, d["neighbor_ids"].reshape(-1),
                             d["F"].reshape(-1, 3, 3),
                             d["pair_valid"].reshape(-1))
    info = {}
    # K1 at k = 20 over every pair (F3): its own row, bound by the
    # candidates' operations, its bytes beside (25 B a slot)
    k20 = matching.match_pairs_cuda(t, eo, 20)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = matching.match_pairs_plain(t, eo, 20, chunk=8)
    end.record()
    torch.cuda.synchronize()
    same_matches(k20, want, f"K1, k = 20, {V * N} pairs, against plain")
    moved = nbytes(t.segments, t.mask, t.r1, t.r2, t.n, t.seglen, t.e1,
                   t.e2, t.num_src, t.num_tgt, t.src_idx, t.tgt_idx,
                   t.pair_valid) + nbytes(*k20)
    ops = K1_OPS_PER_CANDIDATE * k1_candidates(t)
    b_ms, by = bound(ops, moved)
    k1 = lambda: matching.match_pairs_cuda(t, eo, 20)
    row20 = dict(name="K1 match_pairs (k = 20)", route="cuda",
                 source="line3dpp_tpu_torch/csrc/matching.cu",
                 replaces="line3dpp_tpu/ops/matching_pallas.py:233",
                 max_abs_err=0.0, ms=cuda_ms(k1, reps=3),
                 device_ms=device_ms(k1, 3), plain_ms=start.elapsed_time(end),
                 bound_ms=b_ms, bound_by=by,
                 bound_bytes_ms=1e3 * moved / PEAK_BYTES, library_ms=None,
                 shape=f"k = 20, {V * N} pairs", launch_path="knn20")
    del k20, want
    # K1 at k = S over one block's pairs
    tb = pair_subset(t, 0, 3 * N)
    every = matching.match_pairs_cuda(tb, eo, S)
    torch.cuda.synchronize()
    want = matching.match_pairs_plain(tb, eo, S, chunk=2)
    same_matches(every, want, f"K1, k = S = {S}, views 0-2 "
                 f"({3 * N} pairs), against plain")
    del want
    counts = every.valid.sum(-1)
    info["k1_kS_valid_per_row"] = dict(
        mean=float(counts.float().mean()), max=int(counts.max()),
        over_list=int((counts > matching.LIST_LEN).sum()),
        list_len=matching.LIST_LEN, rows=int(counts.numel()))
    print("K1, k = S: rows past the list (the overflow path): "
          + json.dumps(info["k1_kS_valid_per_row"]), flush=True)
    k1 = lambda: matching.match_pairs_cuda(tb, eo, S)
    torch.cuda.synchronize()
    ops = K1_OPS_PER_CANDIDATE * k1_candidates(tb)
    moved = nbytes(tb.segments, tb.mask, tb.r1, tb.r2, tb.n, tb.seglen,
                   tb.e1, tb.e2, tb.num_src, tb.num_tgt, tb.src_idx,
                   tb.tgt_idx, tb.pair_valid) + nbytes(*every)
    plain_ms = cuda_ms(lambda: matching.match_pairs_plain(tb, eo, S, 2),
                       reps=1, warmup=0)
    b_ms, by = bound(ops, moved)
    row1 = dict(name="K1 match_pairs (k = S)", route="cuda",
                source="line3dpp_tpu_torch/csrc/matching.cu",
                replaces="line3dpp_tpu/ops/matching_pallas.py:233",
                max_abs_err=0.0, ms=cuda_ms(k1, reps=3),
                device_ms=device_ms(k1, 3), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=None,
                shape=f"k = S = {S}, {3 * N} pairs", launch_path="all_matches",
                **info)

    # K2 on the all-matches block, from K1's k = S table
    args = block_k2_args(inp, d, every, 0, 3)
    del every
    kw = dict(knn=S, two_sig_a_sqr=cfg.two_sig_a_sqr,
              min_similarity=cfg.min_similarity_3d,
              check_orientation=cfg.check_match_orientation)
    got = scoring.score_matches_cuda(*args, **kw)
    every_pair = scoring.score_matches_cuda(*args, pretest=False, **kw)
    check(torch.equal(got.score3d, every_pair.score3d)
          and torch.equal(got.valid, every_pair.valid),
          "K2 on the all-matches block: its pre-test changes a bit")
    del every_pair
    n = sparse_pretest_counts(args, kw)
    seg_counts = args[9].sum(-1)
    n["segments_over_records"] = int((seg_counts > scoring.RECORDS).sum())
    n["records"] = scoring.RECORDS
    n["max_valid_slots"] = int(seg_counts.max())
    print("K2, all-matches block (views 0-2, M = "
          f"{args[7].shape[2]}; segments past the records take the overflow "
          "path): " + json.dumps(n), flush=True)
    k2 = lambda: scoring.score_matches_cuda(*args, **kw)
    ops = K2_PRETEST_OPS_PER_PAIR * n["pairs"] + K2_OPS_PER_PAIR * n[
        "survivors"]
    moved = k2_bytes(args, got, n["valid_slots"])
    b_ms, by = bound(ops, moved)
    k2_ms, k2_dev = cuda_ms(k2, reps=3), device_sum_ms(k2, calls=3)
    del got, args
    torch.cuda.empty_cache()

    # against the plain scorer at knn = 100 (M = 1600), views 0-2
    pm = matching.match_pairs_cuda(t, eo, K2_WIDE_KNN)
    args = block_k2_args(inp, d, pm, 0, V)
    del pm
    kw100 = dict(kw, knn=K2_WIDE_KNN)
    got = scoring.score_matches_cuda(*args, **kw100)
    sub = tuple(a[:3] for a in args)
    want = scoring.score_matches_plain(*sub, **kw100)
    err = float((got.score3d[:3] - want.score3d).abs().max())
    same = (torch.equal(got.score3d[:3], want.score3d)
            and torch.equal(got.valid[:3], want.valid))
    print(f"K2, knn = {K2_WIDE_KNN} (M = {N * K2_WIDE_KNN}), "
          f"views 0-2 against plain: "
          f"{int(want.valid.sum())} valid slots, bit-equal {same}, max |err| "
          f"{err:.3g}", flush=True)
    check(same, "K2 differs from its plain version at knn = "
          f"{K2_WIDE_KNN}")
    plain_ms = cuda_ms(lambda: scoring.score_matches_plain(*sub, **kw100),
                       reps=1, warmup=0)
    del got, want, sub, args
    row2 = dict(name="K2 score_matches (all matches)", route="cuda",
                source="line3dpp_tpu_torch/csrc/scoring.cu",
                replaces="line3dpp_tpu/ops/scoring_pallas.py:231",
                max_abs_err=err, ms=k2_ms, device_ms=k2_dev,
                plain_ms=plain_ms,
                plain_shape=f"knn = {K2_WIDE_KNN}, views 0-2",
                bound_ms=b_ms, bound_by=by, library_ms=None,
                shape=f"M = {N * S}, views 0-2", work=n,
                launch_path="all_matches")
    del t, tb
    torch.cuda.empty_cache()
    return [row20, row1, row2], n


def txt_bytes(lines) -> bytes:
    """The TXT that ``save_txt`` writes for ``lines``."""
    from line3dpp_tpu_torch.utils import writers

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lines.txt")
        writers.save_txt(path, lines)
        with open(path, "rb") as f:
            return f.read()


def run_views(cfg, views, capture: bool = False) -> tuple:
    """``views`` ((cam_id, Camera, segments)) through Line3D under ``cfg``
    with the launch counters reset before and read after: the pipeline,
    its phases, its launches and what match_images printed."""
    import io as _io
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import kernels

    pipe = lt.Line3D(cfg)
    for cam_id, cam, segs in views:
        pipe.add_view(cam_id, cam, segs)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    printed = _io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed) if capture else \
            contextlib.nullcontext():
        pipe.match_images()
        torch.cuda.synchronize()
    phases = {"match_images_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    lines = pipe.reconstruct_3d_lines()
    phases["reconstruct_3d_lines_s"] = time.perf_counter() - t0
    phases["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    phases["lines"] = len(lines)
    check(all(np.isfinite(l.segments3d).all() for l in lines),
          "non-finite 3D segments")
    return pipe, phases, dict(kernels.LAUNCHES), printed.getvalue()


@contextlib.contextmanager
def one_card_group():
    """The world-size-1 NCCL group of ``sharded.init_group`` on this
    process's card, for the ``with`` block.  This process holds the
    rendezvous store (``sharded.hold_store``) and joins it as a client, as
    a rank of torchrun's agent does: its port is bound before the group
    is set up."""
    import torch.distributed as dist
    from line3dpp_tpu_torch.parallel import sharded

    # a local of this frame: held until the group is destroyed
    store = sharded.hold_store(1)
    saved = {k: os.environ.get(k) for k in sharded.AGENT_STORE_ENV}
    os.environ.update(sharded.AGENT_STORE_ENV)
    try:
        sharded.init_group(0, 1, f"127.0.0.1:{store.port}")
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded_world1(inp, cfg, dev) -> dict:
    """The view-sharded step over NCCL at world size 1 (the one card) on
    the 26 views, against ``forward_step``, bit for bit."""
    import torch
    from line3dpp_tpu_torch.models import step
    from line3dpp_tpu_torch.models.pipeline import STEP_ARRAYS
    from line3dpp_tpu_torch.parallel import sharded

    kw = dict(epipolar_overlap=cfg.epipolar_overlap, knn=inp["knn"],
              two_sig_a_sqr=cfg.two_sig_a_sqr,
              min_similarity=cfg.min_similarity_3d,
              check_orientation=cfg.check_match_orientation,
              min_best_score=cfg.min_best_score_3d,
              min_best_score_perc=cfg.min_best_score_perc,
              min_affinity=cfg.min_affinity, pair_chunk=max(cfg.pair_chunk, 1))
    args = [torch.from_numpy(inp[n]).to(dev) for n in STEP_ARRAYS]
    want = step.forward_step(*args, **kw)
    with one_card_group():
        fn = sharded.sharded_forward_step(**kw)
        t0 = time.perf_counter()
        got = fn(*sharded.shard_inputs(0, 1, *args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    bad = [f for f in want._fields
           if not torch.equal(getattr(got, f), getattr(want, f))]
    print(f"sharded step, NCCL, world size 1, 26 views: fields that differ "
          f"from forward_step: {bad}; {wall:.3f} s", flush=True)
    check(not bad, f"the sharded step differs from forward_step in {bad}")
    return dict(wall_s=wall, est=int(got.est_valid.sum()),
                edges=int(got.aff_valid.sum()))


def scaling_phase(smi_line: str) -> dict:
    """The weak-scaling tool's path on the card: the sharded step over
    NCCL at world size 1 on ``bench.make_workload(*SCALING_WORKLOAD)``
    under ``comm="tile"`` and ``"gather"`` (bit for bit equal, K1-K3 once
    a call under each), then ``python -m
    line3dpp_tpu_torch.tools.bench_scaling --devices 1`` as a process of
    its own (rc 0, one row with the JAX tool's keys at its default sizes,
    ``gather_mb`` by its formula), printed with the card's name and power
    limit."""
    import torch
    from line3dpp_tpu_torch import bench
    from line3dpp_tpu_torch.ops import kernels
    from line3dpp_tpu_torch.parallel import sharded
    from line3dpp_tpu_torch.tools import bench_scaling

    V, S, N = SCALING_WORKLOAD
    out, got = {}, {}
    with one_card_group():
        args = [torch.from_numpy(a).cuda() for a in
                sharded.shard_inputs(0, 1, *bench.make_workload(V, S, N))]
        for comm in ("tile", "gather"):
            fn = sharded.sharded_forward_step(knn=10, pair_chunk=N,
                                              comm=comm)
            kernels.reset_launches()
            t0 = time.perf_counter()
            got[comm] = fn(*args)
            torch.cuda.synchronize()
            out[f"{comm}_s"] = time.perf_counter() - t0
            launches = {k: kernels.LAUNCHES[k] for k in STEP_ONCE}
            out[f"{comm}_launches"] = launches
            check(all(n == 1 for n in launches.values()),
                  f"sharded step, comm={comm}: not K1-K3 once: {launches}")
    bad = [f for f, a, b in zip(got["gather"]._fields, got["tile"],
                                got["gather"])
           if not torch.equal(a.contiguous().view(torch.uint8),
                              b.contiguous().view(torch.uint8))]
    out["tile_fields_differing"] = bad
    out["est"] = int(got["gather"].est_valid.sum())
    print(f"sharded step, NCCL, world size 1, make_workload{(V, S, N)}: "
          f"comm=tile against gather, fields that differ: {bad}; "
          f"launches {json.dumps(out['gather_launches'])}", flush=True)
    check(not bad, f"comm=tile differs from comm=gather in {bad}")
    check(out["est"] > 0, "sharded step: no estimate")
    del got, args
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "line3dpp_tpu_torch.tools.bench_scaling",
         "--devices", "1"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO,
        start_new_session=True)
    try:
        printed, _ = proc.communicate(timeout=SCALING_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"bench_scaling --devices 1 ran past {SCALING_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in printed.splitlines()
            if line.startswith("{")]
    check(proc.returncode == 0 and len(rows) == 1,
          f"bench_scaling --devices 1: rc {proc.returncode}:\n{printed}")
    row = rows[0]
    check(set(row) == {"devices", "V", "S", "N", "step_ms", "nocomm_ms",
                       "compile_s", "gather_mb"}
          and (row["devices"], row["V"], row["S"], row["N"]) == (1, V, S, N)
          and row["gather_mb"] == bench_scaling.gather_mb(V, S)
          and row["step_ms"] > 0 and row["nocomm_ms"] > 0,
          f"bench_scaling --devices 1: unexpected row {row}")
    out["bench_scaling"] = dict(row, wall_s=wall, card=smi_line)
    print(f"bench_scaling --devices 1 ({smi_line}): " + json.dumps(row),
          flush=True)
    return out


def records_phase(views) -> dict:
    """The clustering records on the 26 cached views under
    ``RECORDS_OPTIONS`` (the compensations), ``L3D_SPLIT_DEBUG`` set: one
    ``reconstruct_3d_lines`` with both record lists on and one with them
    off after one ``match_images``.  The TXT must be byte-equal, the
    ``emitted`` records exactly the lines (``line_idx`` over 0 ... L-1,
    the members the lines' residual rows), no node in two cluster
    records, at least one split candidate and one visibility drop, and the
    counters printed once a call."""
    import ast
    import io as _io
    import torch
    import line3dpp_tpu_torch as lt

    pipe = lt.Line3D(lt.Config(**RECORDS_OPTIONS))
    for v in views:
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    pipe.match_images()
    torch.cuda.synchronize()
    runs = []
    saved = os.environ.get("L3D_SPLIT_DEBUG")
    os.environ["L3D_SPLIT_DEBUG"] = "1"
    try:
        for on in (True, False):
            pipe._split_records = [] if on else None
            pipe._cluster_records = [] if on else None
            printed = _io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                lines = pipe.reconstruct_3d_lines()
            runs.append(dict(seconds=time.perf_counter() - t0,
                             txt=txt_bytes(lines), lines=lines,
                             split=pipe._split_records,
                             cluster=pipe._cluster_records,
                             printed=printed.getvalue()))
    finally:
        if saved is None:
            del os.environ["L3D_SPLIT_DEBUG"]
        else:
            os.environ["L3D_SPLIT_DEBUG"] = saved
    on, off = runs
    lines, cluster = on["lines"], on["cluster"]
    prefix = "[L3D-TPU] bimodal split: "
    dbg = [ast.literal_eval(line[len(prefix):]) for r in runs
           for line in r["printed"].splitlines() if line.startswith(prefix)]
    S = pipe._last_state["mask"].shape[1]
    cam_ids = pipe._last_state["cam_ids"]
    emitted = [r for r in cluster if r["outcome"] == "emitted"]
    same_members = all(
        sorted((cam_ids[n // S], n % S) for n in r["nodes"].tolist())
        == sorted(map(tuple, lines[r["line_idx"]].residuals[:, :2]
                      .astype(int).tolist())) for r in emitted)
    nodes = np.concatenate([r["nodes"] for r in cluster])
    out = dict(
        lines=len(lines),
        outcomes={k: sum(r["outcome"] == k for r in cluster) for k in (
            "emitted", "tiny", "sweep-empty", "visibility")},
        split_candidates=len(on["split"]),
        splits_applied=sum(r["applied"] for r in on["split"]),
        dbg=dbg[0] if dbg else None,
        reconstruct_on_s=on["seconds"], reconstruct_off_s=off["seconds"],
        txt_equal=on["txt"] == off["txt"])
    print("records, 26 views, compensations: " + json.dumps(out),
          flush=True)
    check(out["txt_equal"], "records: the TXT with the records on differs "
          "from the TXT with them off")
    check(sorted(r["line_idx"] for r in emitted) == list(range(len(lines)))
          and same_members, "records: the emitted records are not the lines")
    check(len(np.unique(nodes)) == len(nodes),
          "records: a node lies in two cluster records")
    check(out["split_candidates"] > 0 and out["outcomes"]["visibility"] > 0,
          f"records: no split candidate or no visibility drop: {out}")
    check(len(dbg) == 2 and dbg[0] == dbg[1] and all(
        r["printed"].count(prefix) == 1 for r in runs),
        "records: L3D_SPLIT_DEBUG did not print the counters once a call")
    del pipe
    torch.cuda.empty_cache()
    return out


def item14_15_phase(views, cfg, dev, fused_txt: bytes) -> dict:
    """Items 14 and 15 end to end on the card: the 26 views blocked at
    ``view_block`` 4 and 13 (the fused TXT byte for byte, K1 and K2 once a
    block, no K3); the JAX package's 104-view scene fused and at
    ``view_block=26`` (the same TXT); all matches (``knn=0``), which
    auto-blocks at 3 and prints the JAX package's line; ``knn=20`` fused
    (F3); the sharded step over NCCL at world size 1."""
    import dataclasses
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.tools import bench_scale

    out = {}
    cams = [(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
             v.segments) for v in views]
    for vb, blocks in ((4, 7), (13, 2)):
        pipe, phases, launches, _ = run_views(
            dataclasses.replace(cfg, view_block=vb), cams)
        same = txt_bytes(pipe.lines3d) == fused_txt
        phases.update(txt_equal_to_fused=same, launches={
            k: launches[k] for k in ("match_pairs", "score_matches",
                                     "gather_target_estimates")})
        print(f"blocked, view_block={vb}, 26 views: " + json.dumps(phases),
              flush=True)
        check(same, f"view_block={vb}: the TXT differs from the fused run's")
        check(launches["match_pairs"] == blocks
              and launches["score_matches"] == blocks
              and launches["gather_target_estimates"] == 0,
              f"view_block={vb}: K1/K2 not once per block, or K3 launched")
        out[f"blocked_{vb}"] = phases
        del pipe
    torch.cuda.empty_cache()

    # the large scene of tools/bench_scale.py, fused and blocked
    t0 = time.perf_counter()
    scale = [(i, cam, segs) for i, (cam, segs)
             in enumerate(bench_scale.build_scene(104))]
    build_s = time.perf_counter() - t0
    txts = {}
    for vb in (0, 26):
        pipe, phases, launches, _ = run_views(
            dataclasses.replace(cfg, view_block=vb), scale)
        txts[vb] = txt_bytes(pipe.lines3d)
        phases["neighbours"] = int(pipe._last_state["neighbor_ids"].shape[1])
        phases["launches"] = {k: launches[k] for k in (
            "match_pairs", "score_matches", "gather_target_estimates")}
        out[f"scale104_vb{vb}"] = phases
        print(f"104-view scene (S = 3000), view_block={vb}: "
              + json.dumps(phases), flush=True)
        del pipe
        torch.cuda.empty_cache()
    out["scale104_build_s"] = build_s
    check(out["scale104_vb0"]["lines"] > 0, "104 views: no lines")
    check(txts[0] == txts[26], "104 views: blocked and fused TXT differ")

    # all matches: auto-blocked at 2^31 // (3000 * 16 * 3000 * 4) = 3
    pipe, phases, launches, printed = run_views(
        dataclasses.replace(cfg, knn=0), cams, capture=True)
    line = printed.strip()
    V, S = len(cams), cfg.num_segments
    N = pipe._last_state["neighbor_ids"].shape[1]
    fused_bytes = V * S * N * S * 4
    want = (f"[L3D-TPU] match tensors would be "
            f"{fused_bytes / (1 << 30):.1f} GiB per array (knn=0); "
            f"auto-blocking source views at view_block="
            f"{(2 << 30) // (S * N * S * 4)}")
    phases["printed"] = line
    phases["launches"] = {k: launches[k] for k in STEP_ONCE}
    out["all_matches"] = phases
    print("all matches (knn=0), 26 views: " + json.dumps(phases), flush=True)
    check(line == want and want.endswith("view_block=3"),
          f"all matches: printed {line!r}, not {want!r}")
    check(launches["match_pairs"] == 9 and launches["score_matches"] == 9
          and launches["gather_target_estimates"] == 0,
          "all matches: K1 and K2 not once per block, or K3 launched")
    check(phases["lines"] > 0, "all matches: no lines")
    del pipe
    torch.cuda.empty_cache()

    # F3: knn = 20 fused
    pipe, phases, launches, _ = run_views(dataclasses.replace(cfg, knn=20),
                                          cams)
    phases["launches"] = {k: launches[k] for k in STEP_ONCE}
    out["knn20"] = phases
    print("knn=20, 26 views, fused: " + json.dumps(phases), flush=True)
    check(all(launches[k] == 1 for k in STEP_ONCE),
          "knn=20: not K1, K2 and K3 once")
    del pipe
    torch.cuda.empty_cache()
    return out


# the detection kernels of one images -> lines pass
DETECT_KERNELS = ("cc_tiles", "gather_merged", "moments", "gate_moments",
                  "consume_survivors", "extents")
# the kernels that one forward step at k = 10 launches once each
STEP_ONCE = ("match_pairs", "score_matches", "gather_target_estimates")


def drivers_phase(images, cams, gt, image_segs, image_txt: bytes,
                  image_launches: dict, scale_lines: int) -> dict:
    """The port's drivers on the card: ``bench.device_step_bench`` at
    ``bench.py``'s size (every timed run equal to the warm-up bit for bit,
    K1-K3 once a run), ``bench.images_e2e`` on the facade views (the
    images phase's detections bit for bit and its detection launches),
    ``tools.bench_scale.main`` at its defaults (the 104-view blocked run's
    lines), both facade sweeps from the port's detections (the
    ``(0.0, ordered)`` TXT byte for byte the images phase's), all eight
    configurations from JAX's facade detections against
    ``SWEEP_NPZ`` (``SAME_*``, ``BUNDLED_SAME_F1`` with bundling), and
    ``tools.drive_synthetic`` (12 lines, recall and precision 1.0).  Each
    is driven with the launch counters reset just before and read just
    after."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch import bench
    from line3dpp_tpu_torch.ops import kernels
    from line3dpp_tpu_torch.tools import (bench_scale, drive_synthetic,
                                          validate_scene2,
                                          validate_scene2_anchor)

    out = {}

    def counted(fn):
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = fn()
        return got, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    # bench.py's device step, 26 views x 3000 segments x 10 neighbours
    info, wall, launches = counted(bench.device_step_bench)
    out["device_step"] = dict(
        info["result"], runs_s=info["runs_s"], median_s=info["median_s"],
        peak_device_GiB=info["peak_device_GiB"],
        launches_per_run=info["launches_per_run"], wall_s=wall)
    check(info["same_outputs"], "device_step_bench: a timed run differs "
          "from the warm-up run")
    check(all(r == {**dict.fromkeys(bench.STEP_KERNELS, 0),
                    **dict.fromkeys(STEP_ONCE, 1)}
              for r in info["launches_per_run"]),
          "device_step_bench: not K1, K2 and K3 once a run")
    check(launches["match_pairs"] == len(info["runs_s"]) + 1,
          "device_step_bench: launches outside the warm-up and the runs")

    # bench.py's cold images -> lines pass on the facade views
    items = [(i, c, im) for i, (c, im) in enumerate(zip(cams, images))]
    (n, secs, pipe), _, launches = counted(
        lambda: bench.images_e2e(items))
    lines = pipe.lines3d
    same = [np.array_equal(pipe._views[i].segments, image_segs[i])
            for i in range(len(items))]
    out["images_e2e"] = dict(
        images=n, seconds=secs, images_per_sec=n / secs, lines=len(lines),
        detections_equal=all(same),
        launches={k: launches[k] for k in DETECT_KERNELS + STEP_ONCE})
    print("bench.images_e2e, facade: " + json.dumps(out["images_e2e"]),
          flush=True)
    check(all(same), f"images_e2e: detections differ from the images "
          f"phase's in views {[i for i, x in enumerate(same) if not x]}")
    check(all(launches[k] == image_launches[k] for k in DETECT_KERNELS),
          "images_e2e: detection launches differ from the images phase's")
    check(lines and all(np.isfinite(l.segments3d).all() for l in lines),
          "images_e2e: no lines, or non-finite ones")
    del pipe

    # tools/bench_scale.py at its defaults
    result, wall, launches = counted(lambda: bench_scale.main([]))
    out["bench_scale"] = dict(result, wall_s=wall, launches={
        k: launches[k] for k in STEP_ONCE})
    check(result["lines"] == scale_lines, f"bench_scale: {result['lines']} "
          f"lines, the 104-view blocked run gave {scale_lines}")
    torch.cuda.empty_cache()

    # the facade sweeps, from the port's own detections, with the segment
    # cache in a fresh directory: the first configuration detects every
    # view as the images phase did, and no later one (the anchor sweep's
    # included) detects again
    saved_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        try:
            cache = validate_scene2.cache_dir(cams)
            rows, wall, launches = counted(
                lambda: validate_scene2.sweep(images, cams, gt, "cuda"))
            cached = len(os.listdir(cache))
            anchor, wall_a, launches_a = counted(
                lambda: validate_scene2_anchor.sweep(images, cams, gt,
                                                     "cuda"))
        finally:
            tempfile.tempdir = saved_tmp
    txt_same = txt_bytes(rows[0]["lines3d"]) == image_txt
    keep = ("lines", "recall", "precision", "count_f1", "seconds")
    out["validate_scene2"] = dict(
        wall_s=wall, txt_equal_to_images_phase=txt_same,
        cached_views=cached, detection_launches={
            k: launches[k] for k in DETECT_KERNELS},
        rows=[{"split_bimodal_t": r["split_bimodal_t"],
               "symmetrization": r["symmetrization"],
               **{k: r[k] for k in keep}} for r in rows])
    out["validate_scene2_anchor"] = dict(
        wall_s=wall_a, detection_launches={
            k: launches_a[k] for k in DETECT_KERNELS},
        rows=[{"cluster_strong_min": r["cluster_strong_min"],
               **{k: r[k] for k in keep}} for r in anchor])
    check(cached == len(images) and all(
        launches[k] == image_launches[k] for k in DETECT_KERNELS),
        f"validate_scene2: {cached} views cached and detection launches "
        f"{[launches[k] for k in DETECT_KERNELS]}, the images phase's "
        f"{[image_launches[k] for k in DETECT_KERNELS]} on "
        f"{len(images)} views")
    check(not any(launches_a[k] for k in DETECT_KERNELS),
          "validate_scene2_anchor: detected again where the cache holds "
          "the views")
    check(txt_same, "validate_scene2 (0.0, ordered): the TXT differs from "
          "the images phase's")
    check(all(r["lines"] > 0 for r in rows + anchor), "a sweep: no lines")

    # the eight configurations from JAX's detections against JAX's lines
    if not os.path.exists(SWEEP_NPZ):
        fail(f"missing {SWEEP_NPZ} "
             f"(tests/make_torch_scene2_sweep_reference.py)")
    with np.load(SCENE2_NPZ) as data:
        segs = np.split(data["segments"],
                        np.cumsum(data["seg_counts"])[:-1])
        digest = hashlib.sha256(
            np.ascontiguousarray(data["segments"]).tobytes()).hexdigest()
    with np.load(SWEEP_NPZ) as data:
        ref = {k: data[k] for k in data.files}
    check(str(ref["detections"]) == digest,
          "the sweep reference was made from other detections")
    configs = [(f"split_{t}_{sym}", validate_scene2.options(t, sym))
               for t, sym in validate_scene2.CONFIGS]
    configs += [(f"anchor_{a}", validate_scene2_anchor.options(a))
                for a in validate_scene2_anchor.ANCHORS]
    against = {}
    for name, opts in configs:
        check(json.loads(str(ref[f"{name}_config"])) == opts,
              f"{name}: the reference ran other options")
        pipe = lt.Line3D(lt.Config(**opts))
        for i, (c, s) in enumerate(zip(cams, segs)):
            pipe.add_view(i, c, s)
        pipe.match_images()
        pred = [l.segments3d for l in pipe.reconstruct_3d_lines()]
        want = split_lines(ref, f"{name}_")
        bundled = pipe.config.optimize
        against[name] = dict(lines=len(pred), jax_lines=len(want),
                             count_f1=held_lines(
                                 pred, want, f"{name}, JAX's detections",
                                 BUNDLED_SAME_F1 if bundled else SAME_F1))
    out["sweeps_from_jax_detections"] = against

    # tools/drive_synthetic.py
    with tempfile.TemporaryDirectory() as tmp:
        (lines, m), wall, _ = counted(lambda: drive_synthetic.run("cuda",
                                                                  tmp))
    out["drive_synthetic"] = dict(lines=len(lines), wall_s=wall, **m)
    check(len(lines) == 12 and m["recall"] == 1.0
          and m["precision"] == 1.0,
          f"drive_synthetic: {len(lines)} lines, {m}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for the build log and profile")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more match_images run and the "
                         "detection of one facade view")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        clock_mhz = float(clk.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        clock_mhz = None
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi_line} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)

    sys.path.insert(0, REPO)
    try:
        import line3dpp_tpu_torch as lt
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    from line3dpp_tpu_torch.ops import clustering, kernels
    from line3dpp_tpu_torch.utils import golden
    from line3dpp_tpu_torch.utils.testdata import load_views

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- build (the union-find too, so the main path's times exclude g++)
    t0 = time.perf_counter()
    sincos_build = sincos_library(start=True)
    lib = kernels.library_path()
    kernels.library()
    native = clustering._native_lib() is not None
    if sincos_build is not None:
        out, _ = sincos_build.communicate()
        check(sincos_build.returncode == 0,
              f"the sincosf check did not build: {out}")
    build_s = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        build_log = f.read()
    print(f"kernels built in {build_s:.1f} s: {lib}; native union-find: "
          f"{native}", flush=True)
    for line in ptxas_report(build_log):
        print("  ptxas: " + line, flush=True)
    sass = cuobjdump_sass(lib)
    k1_sass = k1_sass_info(sass)
    k2_sass = k2_sass_info(sass)
    if opts.out and sass:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k2_sass.txt"), "w") as f:
            f.write(sass_function(sass, "score_all_kernel") or "")
    t0 = time.perf_counter()
    n_bad, first_bad = sincos_differences(dev)
    print(f"[K8] sincosf against sinf and cosf on all 2^32 float32 "
          f"arguments: {n_bad} differ"
          + (f" (the first {first_bad:#010x})" if n_bad else "")
          + f", in {time.perf_counter() - t0:.2f} s", flush=True)
    check(n_bad == 0, "sincosf and sinf/cosf differ: K8's gate may "
                      "differ from K9's")
    t0 = time.perf_counter()
    n_bad, first_bad = expf_differences(dev)
    print(f"[CL] expf against torch.exp on all 2^32 float32 arguments: "
          f"{n_bad} differ"
          + (f" (the first {first_bad:#010x})" if n_bad else "")
          + f", in {time.perf_counter() - t0:.2f} s", flush=True)
    check(n_bad == 0, "expf and torch.exp differ: the collinearity "
                      "kernel's weights may differ from the plain path's")

    # ---- each kernel against its plain version at main-path shapes
    views = load_views()
    cfg = lt.Config(optimize=False)
    setup = lt.Line3D(cfg)
    for v in views:
        setup.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                       v.segments)
    inp = setup.step_inputs()
    rows = kernel_checks(inp, cfg, dev, k1_sass, k2_sass, clock_mhz)
    del setup
    torch.cuda.synchronize()

    # ---- the main path, through the user entry points
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    t0 = time.perf_counter()
    pipe = lt.Line3D(cfg)
    for v in views:
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    phases["add_view_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.match_images()
    torch.cuda.synchronize()
    phases["match_images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = pipe.reconstruct_3d_lines()
    phases["reconstruct_3d_lines_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        base = os.path.join(tmp, cfg.filename_tag())
        pipe.save_txt(base + ".txt")
        pipe.save_stl(base + ".stl")
        pipe.save_obj(base + ".obj")
        phases["save_s"] = time.perf_counter() - t0
        with open(base + ".txt", "rb") as f:
            fused_txt = f.read()
        n_rows = fused_txt.count(b"\n")
        with open(base + ".stl") as f:
            n_facets = sum(1 for r in f if r.startswith(" endfacet"))
        phases["save_bin_s"] = check_bin_round_trip(pipe, base)
    cached_launches = dict(kernels.LAUNCHES)
    phases["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    print("cached segments -> lines: " + json.dumps(phases), flush=True)
    print("launches: " + json.dumps(cached_launches), flush=True)
    for name in ("match_pairs", "score_matches", "gather_target_estimates"):
        check(cached_launches[name] > 0,
              f"kernel {name} was not launched on the cached-segments path")

    n_segs = sum(len(l.segments3d) for l in lines)
    check(n_rows == len(lines), "TXT rows != line count")
    check(n_facets == n_segs, "STL facets != 3D segment count")
    check(all(np.isfinite(l.segments3d).all() for l in lines),
          "non-finite 3D segments")
    gold = golden.parse_lines3d_txt(GOLDEN)
    check(len(gold) == GOLDEN_LINES, "unexpected golden file")
    gold_segs = golden.stack_golden_segments(gold)
    tol = 0.01 * golden.scene_scale(gold_segs)
    m = golden.segment_set_metrics(
        np.concatenate([l.segments3d for l in lines]), gold_segs, tol)
    m.update(golden.line_match_metrics([l.segments3d for l in lines],
                                       [g.segments3d for g in gold], tol))
    print(f"result: {len(lines)} lines / {n_segs} segments vs "
          f"{GOLDEN_LINES} golden; " + json.dumps(
              {k: round(v, 5) for k, v in m.items()}), flush=True)
    check(abs(len(lines) - GOLDEN_LINES) <= 0.01 * GOLDEN_LINES,
          "line count off by more than 1%")
    check(m["count_f1"] >= 0.99, "count_f1 < 0.99")
    if opts.profile:
        profile(pipe.match_images, "match_images", opts.out)
    del pipe
    torch.cuda.empty_cache()

    # ---- K1 and K2 past the cells' k and M; the blocked path, all matches
    # and knn = 20 through the entry points; the sharded step over NCCL
    wide_rows, _ = wide_kernel_checks(inp, cfg, dev)
    rows += wide_rows
    item14_15 = item14_15_phase(views, cfg, dev, fused_txt)
    item14_15["sharded_nccl_world1"] = sharded_world1(inp, cfg, dev)
    torch.cuda.empty_cache()

    # ---- the weak-scaling tool's path and the clustering records
    scaling = scaling_phase(smi_line)
    records = records_phase(views)

    # ---- the same views under the default Config(): bundling on
    rows.append(bundled_cached(views, dev, opts))
    torch.cuda.empty_cache()

    # ---- the worldpoint neighbours (COLMAP model) and item 13's options
    item11_13 = {"colmap": colmap_phase(dev), "features": features_phase(dev)}
    rows.append(item11_13["features"].pop("kernel_row"))

    # ---- images -> lines on the full-size facade
    if not os.path.exists(SCENE2_NPZ):
        fail(f"missing {SCENE2_NPZ} (tests/make_torch_lsd_reference.py)")
    with np.load(SCENE2_NPZ) as data:
        ref = {k: data[k] for k in data.files}
    images, cams, gt, render_s = render_scene(ref)
    from line3dpp_tpu_torch.ops import lsd
    from line3dpp_tpu_torch.utils import synthetic

    undistorted = check_undistort(images[0], cams[0].K, dev)
    img, _ = lsd._prepare(images[0], -1, dev)
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    rows += check_lsd_kernels(*lsd._grad_compact(img), (th, tw), dev,
                              "facade view 0")
    facade_rounds = check_facade_rounds(img, dev)
    # the same at a real photo's density, where the work is not launches
    full = {}
    for frac in FULL_SIZE_ACTIVE:
        full[f"active {frac}"] = [
            {k: r.get(k) for k in FULL_SIZE_KEYS}
            for r in check_lsd_kernels(*synthetic_round1(frac, 0, dev), dev,
                                       f"synthetic, {frac} active")]
    full[f"stripes {STRIPE_ACTIVE}"] = [
        {k: r.get(k) for k in FULL_SIZE_KEYS}
        for r in check_lsd_kernels(
            *synthetic_stripes(STRIPE_ACTIVE, 0, dev), dev,
            f"stripes of {STRIPE_ROWS} rows, {STRIPE_ACTIVE} active")]
    torch.cuda.synchronize()
    default_launches, phases, i2l = images_to_lines(images, cams, gt, ref,
                                                    dev)
    phases["render_s"] = render_s
    print("images -> lines phases: " + json.dumps(phases), flush=True)

    # ---- the command line on the same views, as PGM files and an NVM
    image_segs = {i: e.segments for i, e in i2l._views.items()}
    image_txt = txt_bytes(i2l.lines3d)
    item11_13["cli"] = cli_phase(images, cams, gt, ref, image_segs,
                                 [l.segments3d for l in i2l.lines3d], dev)
    del i2l

    # ---- the same images under Config(lsd_rescue=True), bundling on: the
    # path whose launches the kernels line reports
    if not os.path.exists(RESCUE_NPZ):
        fail(f"missing {RESCUE_NPZ} (tests/make_torch_lsd_reference.py "
             f"--rescue)")
    with np.load(RESCUE_NPZ) as data:
        ref = {k: data[k] for k in data.files}
    n_ref = len(ref["seg_counts"])
    check(list(ref["digests"]) == [synthetic.image_digest(im)
                                   for im in images[:n_ref]],
          "the rescue reference was made from other images")
    launches, phases, _ = images_to_lines(images[:n_ref], cams[:n_ref], gt,
                                          ref, dev, rescue=True)
    print("images -> lines with the rescue cascade, phases: "
          + json.dumps(phases), flush=True)
    rect_launches = detect_rect_improve(images[0], dev)
    if opts.profile:
        profile(lambda: lsd.detect_batch(images[:1], device=dev),
                "detect_view0", opts.out)
        profile(lambda: lsd.detect_batch(images[:1], rescue=True,
                                         device=dev),
                "detect_view0_rescue", opts.out)

    # ---- the drivers: bench.py's metric and images pass, the tools
    drivers = drivers_phase(images, cams, gt, image_segs, image_txt,
                            default_launches,
                            item14_15["scale104_vb26"]["lines"])

    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "build.log"), "w") as f:
            f.write(build_log)
    for r in rows:
        # launches: the rescue path, which runs every kernel; also those of
        # the default Config()'s detection (no K10)
        key = r["name"].split()[1]
        r["launches"] = r.pop("pipeline_launches", launches[key])
        r["launches_default"] = default_launches[key]
        r["launches_rect_improve"] = rect_launches[key]
        path = r.pop("launch_path", None)
        if path:
            # the rows past the cells' k and M: all matches on the 26
            # views, or the knn = 20 run for K1's row at k = 20
            r["launches"] = item14_15[path]["launches"][key]
    print(json.dumps({"undistort": undistorted}), flush=True)
    print(json.dumps({"facade_rounds": facade_rounds}), flush=True)
    print(json.dumps({"full_size": full}), flush=True)
    print(json.dumps({"item11_13": item11_13}), flush=True)
    print(json.dumps({"item14_15": item14_15}), flush=True)
    print(json.dumps({"drivers": drivers}), flush=True)
    print(json.dumps({"scaling": scaling}), flush=True)
    print(json.dumps({"records": records}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def profile(fn, label: str, out_dir) -> None:
    """Device time by kernel over one more run of ``fn``, and the share of
    the profiled span in which the device was busy."""
    prof, events, wall = device_events(
        fn, os.path.join(out_dir, f"{label}_trace.json") if out_dir else None)
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25), flush=True)
    busy, n_device = device_busy_us(events)
    # every device-to-host copy is a host sync (.item(), int(), nonzero)
    n_sync = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
                 and "DtoH" in e.get("name", ""))
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    # the span covers the torch ops; the wall time adds host work outside
    # them (for match_images: neighbour choice, fundamental matrices)
    print(f"profile: {label} wall {1e3 * wall:.3f} ms, torch-op span "
          f"{span / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / span:.1f}% of the span, "
          f"{busy / 1e4 / wall:.1f}% of the wall), {n_device} device "
          f"events, {n_sync} host syncs (device-to-host copies)",
          flush=True)


if __name__ == "__main__":
    main()
