#!/usr/bin/env python3
"""Kernel K6 with the map (gather_merged) and K9's consume form
(consume_survivors) against what they replace in an earlier version of the
source, on one GPU, in turns (old, new, new, old).

    python tests/measure_torch_k6_k9.py --old DIR [--out DIR] [--rounds 2]
                                        [--profile] [--detect]
                                        [--consume-layouts THREADS,ITEMS ...]
                                        [--consume-variants ...]

``--old`` is a checkout of the tree whose ``line3dpp_tpu_torch/csrc/
lsd_gather.cu`` and ``lsd_fit.cu`` hold the earlier kernels (for example
``mkdir -p build/old && git archive <commit> | tar -x -C build/old``); they
are compiled with the package's nvcc flags into a library of their own and
called through their plain C interfaces.

- The merged labels: the earlier K5 (the dense merge pass over the grid)
  then K6 (the gather at the pixel list) against K6 with the map, both
  into preallocated outputs, bit equality checked; also K6 without the map
  (``gather_labels``) of both versions.
- The consume step: the earlier K9 (``gate_pixels`` into a preallocated
  plane) against K9's consume form (``consume_survivors_into``), the
  kernels alone; and the whole step, the earlier one (a fill of ones, K9,
  two element-wise passes, three mask indexings, each a host sync) against
  ``consume_survivors_cuda`` (one launch, one read of the count): their
  card time summed over the profiled device events and their time per
  call by CUDA events, the host's share included.  The survivors of both
  are checked equal bit for bit, and K9's gate_pixels form of both
  versions too.

``device_ms`` is the card's time per call (calls queued behind a sleep
kernel), ``event_ms`` CUDA events around the calls.  Inputs: facade view
0's three rounds (the gathers) and two consume steps as one detection at
3072 x 2304 gives them, and the round-1 lists of the synthetic 1920 x 2560
grids of ``chip_smoke.py`` (30 / 47 / 57% active, and the stripes at 47%),
consumed with every component's band as if accepted, as ``chip_smoke.py``
checks them.  ``--profile`` adds each version's device time by kernel
(torch.profiler, 10 calls); ``--consume-layouts`` times fixed layouts of
the consume form (``launch_consume<THREADS, ITEMS>`` of
``csrc/lsd_fit.cu``: threads a block, pixels a thread; built through a
shim source, ``measure_torch_k2_k11.shim_libraries``) on each input,
their survivors checked equal to the package's; ``--consume-variants``
times copies of it with parts switched off or changed (``K9_VARIANTS``),
checked equal where every part is on.  ``--detect`` profiles one
detection of facade view 0, plain and with the rescue cascade, on this
tree and on ``--old``'s (each in a process of its own, in turns): wall
time, device busy time, device events and host syncs (device-to-host
copies).  Prints one JSON line and
writes it to ``--out``/k6_k9_turns.json.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from measure_torch_k1_k4 import by_kernel, turns  # noqa: E402
from measure_torch_k2_k11 import shim_libraries  # noqa: E402

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# K9's consume form at a fixed layout LAYOUT = THREADS, ITEMS, with the
# arguments of l3d_consume_survivors
K9_FIXED = r"""
extern "C" int l3d_consume_fixed(
    const int* slot, const float* xs, const float* ys, const float* ang,
    const int64_t* idx, const float* mag, const float* tables, int n, int C,
    float cos_tol, unsigned long long* status, int64_t status_len,
    unsigned epoch, int64_t* idx_out, float* mag_out, float* ang_out,
    int* count, void* stream) {
  return launch_consume<LAYOUT>(
      consume_args(slot, xs, ys, ang, idx, mag, tables, n, C, cos_tol, status,
                   epoch, idx_out, mag_out, ang_out, count),
      status_len, (cudaStream_t)stream);
}
"""


# the consume form with parts switched off or changed, at VARIANT =
# THREADS, ITEMS, LB, WR, PL, GT: LB 0 no look-back (tile t writes from
# t * tile), 1 the look-back, 2 the look-back with a __nanosleep backoff
# while a window is not posted; WR 0 the survivors are not written; PL 0
# no index or magnitude loads, 1 loaded with the planes, 2 loaded after
# the ballot for the survivors only; GT 0 no gate (no table rows, no
# angle: a pixel of a real component survives where its x is odd), 1 the
# gate (gate_row)
K9_VARIANTS = r"""
__device__ int look_back_sleep(const unsigned long long* status, int64_t t,
                               unsigned epoch, int lane) {
  int sum = 0;
  for (int64_t k = t - 1;; k -= 32) {
    const int64_t j = k - lane;
    unsigned long long w;
    while (true) {
      w = j >= 0 ? read_status(status + j) : status_word(epoch, true, 0);
      if (__all_sync(kFull, (unsigned)(w >> 32) == epoch)) break;
      __nanosleep(64);
    }
    const unsigned inclusive = __ballot_sync(kFull, (w >> 31) & 1);
    const int v = (int)(w & 0x7fffffffull);
    if (inclusive) {
      const int first = __ffs(inclusive) - 1;
      return sum + warp_sum(lane <= first ? v : 0);
    }
    sum += warp_sum(v);
  }
}

template <int THREADS, int ITEMS, int LB, int WR, int PL, int GT>
__global__ void __launch_bounds__(THREADS) consume_variant(const GateArgs a) {
  constexpr int kWarps = THREADS / 32;
  constexpr int64_t kTile = THREADS * ITEMS;
  __shared__ int s_warp[kWarps];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = a.C;
  const int64_t n = a.n, t = blockIdx.x;
  const int64_t i0 = t * kTile + (int64_t)warp * 32 * ITEMS + lane;
  int s[ITEMS];
  float x[ITEMS], y[ITEMS], an[ITEMS], mg[ITEMS];
  int64_t id[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int64_t i = i0 + 32 * q;
    const bool in = i < n;
    s[q] = in ? a.slot[i] : C;
    x[q] = in ? a.xs[i] : 0.f;
    y[q] = in ? a.ys[i] : 0.f;
    an[q] = in ? a.ang[i] : 0.f;
    id[q] = PL == 1 && in ? a.idx[i] : i;
    mg[q] = PL == 1 && in ? a.mag[i] : 0.f;
  }
  unsigned m[ITEMS];
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    bool alive = i0 + 32 * q < n;
    if (alive && s[q] < C) {
      if (GT) {
        const float4 ra = a.tab[2 * (int64_t)s[q]];
        const float4 rb = a.tab[2 * (int64_t)s[q] + 1];
        alive = gate_row(ra, rb, x[q], y[q], an[q], 1.f, a.cos_tol) == 0.f;
      } else {
        alive = ((int)x[q] & 1) != 0;
      }
    }
    m[q] = __ballot_sync(kFull, alive);
    cnt += __popc(m[q]);
  }
  if (PL == 2) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (m[q] >> lane & 1u) {
        id[q] = a.idx[i0 + 32 * q];
        mg[q] = a.mag[i0 + 32 * q];
      }
    }
  }
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? s_warp[lane] : 0;
    int inc = v;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += o;
    }
    const int agg = __shfl_sync(kFull, inc, kWarps - 1);
    if (lane < kWarps) s_warp[lane] = inc - v;
    int base = LB == 0 ? (int)(t * kTile) : 0;
    if (LB != 0 && t > 0) {
      if (lane == 0)
        post_status(a.status + t, status_word(a.epoch, false, agg));
      base = LB == 2 ? look_back_sleep(a.status, t, a.epoch, lane)
                     : look_back(a.status, t, a.epoch, lane);
    }
    if (lane == 0) {
      if (LB != 0)
        post_status(a.status + t, status_word(a.epoch, true, base + agg));
      s_base = base;
      if ((t + 1) * kTile >= n) *a.count = base + agg;
    }
  }
  __syncthreads();
  int64_t r = (int64_t)s_base + s_warp[warp];
  const unsigned below = (1u << lane) - 1u;
  int64_t keep = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    if (m[q] >> lane & 1u) {
      const int64_t o = r + __popc(m[q] & below);
      if (WR) {
        a.idx_out[o] = id[q];
        a.mag_out[o] = mg[q];
        a.ang_out[o] = an[q];
      } else {
        keep ^= id[q] ^ __float_as_int(mg[q]) ^ __float_as_int(an[q]) ^ o;
      }
    }
    r += __popc(m[q]);
  }
  if (!WR && keep == 0x7fffffffffffll) a.idx_out[0] = keep;
}

template <int THREADS, int ITEMS, int LB, int WR, int PL, int GT>
int launch_variant(const GateArgs& a, int64_t status_len,
                   cudaStream_t stream) {
  const int64_t tiles = (a.n + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  if (tiles > status_len || a.epoch == 0) return (int)cudaErrorInvalidValue;
  consume_variant<THREADS, ITEMS, LB, WR, PL, GT>
      <<<(unsigned)tiles, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int l3d_consume_fixed(
    const int* slot, const float* xs, const float* ys, const float* ang,
    const int64_t* idx, const float* mag, const float* tables, int n, int C,
    float cos_tol, unsigned long long* status, int64_t status_len,
    unsigned epoch, int64_t* idx_out, float* mag_out, float* ang_out,
    int* count, void* stream) {
  return launch_variant<LAYOUT>(
      consume_args(slot, xs, ys, ang, idx, mag, tables, n, C, cos_tol, status,
                   epoch, idx_out, mag_out, ang_out, count),
      status_len, (cudaStream_t)stream);
}
"""


def layout_libraries(layouts, variants=()) -> dict:
    """The consume form once per fixed layout ``THREADS,ITEMS`` and once
    per variant ``THREADS,ITEMS,LB,WR,PL,GT`` (``K9_VARIANTS``)."""
    out = shim_libraries("k9", K9_FIXED, layouts)
    out.update(shim_libraries("k9v", K9_VARIANTS, variants))
    for lib in out.values():
        # l3d_consume_survivors' arguments without the pixels a thread
        lib.l3d_consume_fixed.argtypes = ([_P] * 7 + [_I] * 2 + [_F]
                                          + [_P, _L, ctypes.c_uint]
                                          + [_P] * 4 + [_P])
        lib.l3d_consume_fixed.restype = ctypes.c_int
    return out


# one detection of facade view 0, plain and with the rescue, profiled in the
# tree the process runs in (its own package and chip_smoke.py)
DETECT_PROFILE = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from line3dpp_tpu_torch.ops import lsd
from line3dpp_tpu_torch.utils import synthetic

quads, _ = synthetic.build_scene()
cam = synthetic.make_cameras(10, width=3072, height=2304)[0]
img = synthetic.render(cam, quads, seed=100, ss=1)
out = {}
for rescue in (False, True):
    run = lambda: lsd.detect_batch([img], rescue=rescue, device="cuda")
    run()
    _, events, wall = chip_smoke.device_events(run)
    busy, n = chip_smoke.device_busy_us(events)
    syncs = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
                and "DtoH" in e.get("name", ""))
    out["rescue" if rescue else "default"] = dict(
        wall_ms=1e3 * wall, busy_ms=busy / 1e3, events=n, syncs=syncs)
print(json.dumps(out))
"""


def detect_turns(old_root: str, rounds: int) -> dict:
    """``DETECT_PROFILE`` in this tree and in ``old_root``, in turns."""
    out = {"old": [], "new": []}
    for k in ["old", "new", "new", "old"] * rounds:
        proc = subprocess.run(
            [sys.executable, "-c", DETECT_PROFILE],
            cwd=old_root if k == "old" else REPO, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            chip_smoke.fail(f"the {k} tree's detection profile failed: "
                            f"{proc.stderr[-2000:]}")
        out[k].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return out


def old_library(old_root: str) -> ctypes.CDLL:
    """The earlier lsd_gather.cu and lsd_fit.cu, built once into
    build/kernels_k69/<hash>/."""
    from line3dpp_tpu_torch.ops import kernels

    srcs = [os.path.join(old_root, "line3dpp_tpu_torch", "csrc", f)
            for f in ("lsd_gather.cu", "lsd_fit.cu")]
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(REPO, "build", "kernels_k69", h.hexdigest()[:16])
    lib = os.path.join(out_dir, "lib.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                        *srcs, "-o", lib], check=True)
    old = ctypes.CDLL(lib)
    old.l3d_apply_merge_dense.argtypes = [_P] * 2 + [_L] + [_P] + [_P]
    old.l3d_gather_labels.argtypes = [_P] * 2 + [_L] + [_P] + [_P]
    old.l3d_gate_pixels.argtypes = [_P] * 6 + [_I] * 3 + [_F] + [_P] + [_P]
    for fn in (old.l3d_apply_merge_dense, old.l3d_gather_labels,
               old.l3d_gate_pixels):
        fn.restype = ctypes.c_int
    return old


def grid_inputs(dev) -> dict:
    """Per synthetic grid, its round-1 gather ``(lab, T, idx)`` and consume
    step (the arguments of ``consume_survivors``), every component's band
    taken as accepted."""
    import torch
    from line3dpp_tpu_torch.ops import lsd, lsd_cc, lsd_fit

    grids = {f"active {frac}": chip_smoke.synthetic_round1(frac, 0, dev)
             for frac in chip_smoke.FULL_SIZE_ACTIVE}
    grids[f"stripes {chip_smoke.STRIPE_ACTIVE}"] = \
        chip_smoke.synthetic_stripes(chip_smoke.STRIPE_ACTIVE, 0, dev)
    out = {}
    for name, (angle, active, idx, mag_c, ang_c, tile) in grids.items():
        lab, _ = lsd_cc.cc_tiles_cuda(angle, active, lsd.PREC, tile)
        T, _ = lsd_cc.merge_tile_labels(lab, angle, active, lsd.PREC, tile)
        pl = lsd._pixel_list(angle, active, idx, mag_c, ang_c, lsd.PREC, tile)
        slot, xs, ys, C = pl["slot"], pl["xs"], pl["ys"], pl["C"]
        ones = torch.ones(pl["n"], device=dev)
        mom = lsd_fit.moments_plain(slot, xs, ys, pl["mag_s"], ones, C)
        tables, npix, _ = lsd._axis_tables(mom)
        f = lsd._rectangles(tables, npix, lsd_fit.extents_plain(
            slot, xs, ys, ones, tables, C))
        t9 = lsd._consume_tables(f, torch.ones(C, dtype=torch.bool,
                                               device=dev))
        out[name] = dict(
            gather=[(lab, T, idx)],
            consume=[(slot, xs, ys, pl["idx_s"], pl["mag_s"], pl["ang_s"],
                      t9, lsd.COS_GATE, C)])
    return out


def step_turns(step: dict, rounds: int) -> dict:
    """The card time (summed device events) and the event time per call
    of each version of a step that syncs with the host, in turns."""
    import numpy as np

    out = {k: {"device_sum_ms": [], "event_ms": []} for k in step}
    for k in ["old", "new", "new", "old"] * rounds:
        out[k]["device_sum_ms"].append(chip_smoke.device_sum_ms(step[k]))
        out[k]["event_ms"].append(chip_smoke.cuda_ms(step[k], 20))
    for k in out:
        for m in ("device_sum_ms", "event_ms"):
            out[k][m + "_mean"] = float(np.mean(out[k][m]))
    return out


def consume_layouts(fixed: dict, args, outs, want, dev) -> dict:
    """The card time of each fixed layout of the consume form on one input,
    and of the package's (``new``), its survivors equal to ``want``."""
    import torch
    from line3dpp_tpu_torch.ops import kernels, lsd_fit

    slot, xs, ys, idx_s, mag, ang, tables, cos_tol, C = args
    n = slot.numel()
    # one word per tile of the smallest layout; a new epoch every call
    words = torch.zeros(n // 32 + 2, dtype=torch.int64, device=dev)
    epoch = [0]
    p, stream = kernels.ptr, kernels.stream(dev)

    def call(lib):
        epoch[0] += 1
        rc = lib.l3d_consume_fixed(
            p(slot), p(xs), p(ys), p(ang), p(idx_s), p(mag), p(tables), n, C,
            ctypes.c_float(cos_tol), p(words), words.numel(), epoch[0],
            p(outs[0]), p(outs[1]), p(outs[2]), p(outs[3]), stream)
        if rc != 0:
            chip_smoke.fail(f"a fixed consume layout: CUDA error {rc}")

    res = {}
    for layout, lib in fixed.items():
        call(lib)
        k = int(outs[3])
        v = [int(x) for x in layout.split(",")]
        if len(v) == 2 or (v[2] and v[3] and v[4] and v[5]):
            # a layout, or a variant with every part on
            same = k == want[0].numel() and all(
                torch.equal(o[:k], w) for o, w in zip(outs, want))
            chip_smoke.check(same, f"consume layout {layout} differs")
        res[layout] = chip_smoke.device_ms(lambda lib=lib: call(lib), 20)
    res["new"] = chip_smoke.device_ms(
        lambda: lsd_fit.consume_survivors_into(*args, *outs), 20)
    return res


def facade_rounds(dev) -> dict:
    """Facade view 0's rounds as one detection gives them."""
    from line3dpp_tpu_torch.ops import lsd
    from line3dpp_tpu_torch.utils import synthetic

    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=3072, height=2304)[0]
    img, _ = lsd._prepare(synthetic.render(cam, quads, seed=100, ss=1), -1,
                          dev)
    calls = chip_smoke.record_rounds(img)
    out = {}
    for r, g in enumerate(calls["gather"], 1):
        out[f"facade view 0, round {r}"] = dict(gather=[g], consume=[])
    for r, c in enumerate(calls["consume"], 1):
        out[f"facade view 0, round {r}"]["consume"] = [c]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="checkout holding the earlier kernel sources")
    ap.add_argument("--out", help="directory for k6_k9_turns.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also print each version's device time by kernel "
                         "(torch.profiler, 10 calls)")
    ap.add_argument("--detect", action="store_true",
                    help="also profile one detection of facade view 0 on "
                         "both trees")
    ap.add_argument("--consume-layouts", nargs="*", default=[],
                    metavar="THREADS,ITEMS",
                    help="also time these fixed layouts of the consume form")
    ap.add_argument("--consume-variants", nargs="*", default=[],
                    metavar="THREADS,ITEMS,LB,WR,PL,GT",
                    help="also time these variants of the consume form, "
                         "parts switched off or changed (K9_VARIANTS)")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    from line3dpp_tpu_torch.ops import kernels, lsd_fit, lsd_gather

    dev = torch.device("cuda")
    old = old_library(opts.old)
    fixed = layout_libraries(opts.consume_layouts, opts.consume_variants)
    p, stream = kernels.ptr, kernels.stream(dev)
    result = {"card": smi}

    def ok(rc, what):
        if rc != 0:
            chip_smoke.fail(f"{what}: CUDA error {rc}")

    cases = facade_rounds(dev)
    cases.update(grid_inputs(dev))
    for name, case in cases.items():
        r = {}
        for lab, T, idx in case["gather"]:
            n = idx.numel()
            dense = torch.empty_like(lab)
            outs = {k: torch.empty(n, dtype=torch.int32, device=dev)
                    for k in ("old", "new", "old6", "new6")}
            merged = {
                "old": lambda: (
                    ok(old.l3d_apply_merge_dense(p(lab), p(T), lab.numel(),
                                                 p(dense), stream), "old K5"),
                    ok(old.l3d_gather_labels(p(dense), p(idx), n,
                                             p(outs["old"]), stream),
                       "old K6")),
                "new": lambda: kernels.launch(
                    "l3d_gather_merged", p(lab), p(T), p(idx), lab.numel(), n,
                    p(outs["new"]), stream)}
            plain6 = {
                "old": lambda: ok(old.l3d_gather_labels(
                    p(dense), p(idx), n, p(outs["old6"]), stream), "old K6"),
                "new": lambda: kernels.launch(
                    "l3d_gather_labels", p(dense), p(idx), n,
                    p(outs["new6"]), stream)}
            for fn in (*merged.values(), *plain6.values()):
                fn()
            torch.cuda.synchronize()
            same = (torch.equal(outs["old"], outs["new"])
                    and torch.equal(outs["old6"], outs["new6"])
                    and torch.equal(outs["new"],
                                    lsd_gather.gather_merged_plain(lab, T,
                                                                   idx)))
            chip_smoke.check(same, f"{name}: K6 with the map differs from "
                                   f"K5 then K6")
            r["gather"] = dict(
                pixels=n, equal=same,
                bound_ms=chip_smoke.bound(0, 20 * n)[0],
                k5_k6_vs_merged=turns(merged, opts.rounds, reps=20),
                k6_old_vs_new=turns(plain6, opts.rounds, reps=20),
                wrappers_event_ms=dict(
                    k5_k6=chip_smoke.cuda_ms(
                        lambda: lsd_gather.gather_labels_cuda(
                            lsd_gather.apply_merge_dense_cuda(lab, T)
                            .reshape(-1), idx), 20),
                    merged=chip_smoke.cuda_ms(
                        lambda: lsd_gather.gather_merged_cuda(lab, T, idx),
                        20)))
            t = r["gather"]["k5_k6_vs_merged"]
            print(f"{name}: {n} pixels; K5 + K6 "
                  f"{t['old']['device_ms_mean']:.5f} ms, K6 with the map "
                  f"{t['new']['device_ms_mean']:.5f} ms on the card",
                  flush=True)
            if opts.profile:
                for k, fn in merged.items():
                    print(f"{name} gather {k} by kernel (us): "
                          f"{json.dumps(by_kernel(fn))}", flush=True)
        for args in case["consume"]:
            slot, xs, ys, idx_s, mag, ang, tables, cos_tol, C = args
            n = slot.numel()
            ones = torch.ones_like(xs)
            newpix = {k: torch.empty_like(xs) for k in ("old", "new")}
            outs = (torch.empty_like(idx_s), torch.empty_like(mag),
                    torch.empty_like(ang),
                    torch.empty(1, dtype=torch.int32, device=dev))

            def old_k9(pix):
                ok(old.l3d_gate_pixels(p(slot), p(xs), p(ys), p(ang), p(pix),
                                       p(tables), n, C, 0, cos_tol,
                                       p(newpix["old"]), stream), "old K9")
                return newpix["old"]

            def old_step():
                alive = ~(old_k9(torch.ones_like(xs)) != 0.0)
                return idx_s[alive], mag[alive], ang[alive]

            kernel = {"old": lambda: old_k9(ones),
                      "new": lambda: lsd_fit.consume_survivors_into(
                          *args, *outs)}
            gate = {"old": lambda: old_k9(ones),
                    "new": lambda: kernels.launch(
                        "l3d_gate_pixels", p(slot), p(xs), p(ys), p(ang),
                        p(ones), p(tables), n, C, 0,
                        ctypes.c_float(cos_tol), p(newpix["new"]), stream)}
            step = {"old": old_step,
                    "new": lambda: lsd_fit.consume_survivors_cuda(*args)}
            want = old_step()
            got = step["new"]()
            gate["new"]()
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(got, want))
                    and torch.equal(newpix["old"], newpix["new"]))
            chip_smoke.check(same, f"{name}: the consume form differs from "
                                   f"the earlier K9 and the mask")
            r["consume"] = dict(
                pixels=n, components=C, survivors=got[0].numel(), equal=same,
                bound_ms=chip_smoke.bound(
                    chip_smoke.K9_OPS_PER_PIXEL * int((slot < C).sum()),
                    chip_smoke.consume_bytes(slot, xs, ys, ang, tables,
                                             got[0].numel()))[0],
                k9_vs_consume_kernel=turns(kernel, opts.rounds, reps=20),
                k9_gate_old_vs_new=turns(gate, opts.rounds, reps=20),
                step=step_turns(step, opts.rounds))
            t = r["consume"]["k9_vs_consume_kernel"]
            st = r["consume"]["step"]
            print(f"{name}: {n} pixels, {got[0].numel()} survive; K9 "
                  f"{t['old']['device_ms_mean']:.5f} ms, consume form "
                  f"{t['new']['device_ms_mean']:.5f} ms on the card; the "
                  f"step on the card {st['old']['device_sum_ms_mean']:.5f} "
                  f"/ {st['new']['device_sum_ms_mean']:.5f} ms, per call "
                  f"{st['old']['event_ms_mean']:.5f} / "
                  f"{st['new']['event_ms_mean']:.5f} ms", flush=True)
            if opts.profile:
                for k, fn in step.items():
                    print(f"{name} consume step {k} by kernel (us): "
                          f"{json.dumps(by_kernel(fn))}", flush=True)
            if fixed:
                r["consume"]["layouts"] = consume_layouts(
                    fixed, args, outs, got, dev)
                print(f"{name} consume layouts, card ms: "
                      f"{json.dumps(r['consume']['layouts'])}", flush=True)
        result[name] = r
        torch.cuda.empty_cache()

    if opts.detect:
        result["detect"] = detect_turns(opts.old, opts.rounds)
        print(f"detection of facade view 0: {json.dumps(result['detect'])}",
              flush=True)

    line = json.dumps(result)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k6_k9_turns.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
