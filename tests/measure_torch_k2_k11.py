#!/usr/bin/env python3
"""Kernels K2 and K11 against an earlier version of their sources, on one
GPU, in turns (old, new, new, old), on the inputs ``chip_smoke.py`` gives
them.

    python tests/measure_torch_k2_k11.py --old DIR [--out DIR] [--rounds 2]
                                         [--profile]
                                         [--k11-layouts T,I,OVER,MINB ...]

``--old`` is a checkout of the tree whose ``line3dpp_tpu_torch/csrc/
scoring.cu`` and ``lsd_fit.cu`` are the earlier kernels (for example
``mkdir -p build/old && git archive <commit> | tar -x -C build/old``); the
two sources are compiled there with the package's nvcc flags into a library
of their own and called through their plain C interfaces (the earlier
``l3d_score_matches`` takes no pre-test thresholds, the earlier
``l3d_extents`` no run table).  Both versions launch on preallocated
outputs, so the times are the kernels' own: ``device_ms`` (calls queued
behind a sleep kernel, the card's time per call) and ``event_ms`` (CUDA
events around the calls, the host's launch included).  Their outputs must
be equal bit for bit.

Inputs: K2 on the 26 bundled views (S = 3000, N = 16, k = 10, M = 160),
from K1's match table, with the counts of its pre-test
(``chip_smoke.pretest_counts``: the pairs each test keeps, the survivors, the
warp steps with a surviving lane in the kernel's layout and in the other
one, the segments with no valid slot); K11 on facade view 0's round-1 list
at 3072 x 2304 and on the synthetic 1920 x 2560 grids of ``chip_smoke.py``
(30 / 47 / 57% active, and the stripes at 47%), with the first fit's
tables, as ``chip_smoke.py`` checks it.  ``--profile`` adds each version's
device time by kernel (torch.profiler, 10 calls); ``--k11-layouts`` times
fixed layouts of the current K11 (``launch_extents<THREADS, I, OVER, MINB>``
of ``csrc/lsd_fit.cu``, built through a shim source: :func:`shim_libraries`)
against the earlier kernel on each K11 input.
Prints one JSON line and writes it to ``--out``/k2_k11_turns.json.
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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def old_library(old_root: str) -> ctypes.CDLL:
    """The earlier scoring.cu and lsd_fit.cu, built once into
    build/kernels_old/<hash>/."""
    from line3dpp_tpu_torch.ops import kernels

    srcs = [os.path.join(old_root, "line3dpp_tpu_torch", "csrc", f)
            for f in ("scoring.cu", "lsd_fit.cu")]
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(REPO, "build", "kernels_old", h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libold.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                        *srcs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    cdll.l3d_score_matches.argtypes = ([_P] * 10 + [_I] * 5 + [_F] * 2
                                       + [_I] + [_P] * 2 + [_P])
    cdll.l3d_extents.argtypes = [_P] * 5 + [_I] * 2 + [_P] + [_P]
    for fn in (cdll.l3d_score_matches, cdll.l3d_extents):
        fn.restype = ctypes.c_int
    return cdll


LSD_FIT_CU = os.path.join(REPO, "line3dpp_tpu_torch", "csrc", "lsd_fit.cu")

# K11 at a fixed layout LAYOUT = THREADS, I, OVER, MINB (threads a block,
# pixels a lane, 32-pixel groups read past a warp's span, least blocks an SM)
K11_FIXED = r"""
extern "C" int l3d_extents_fixed(const int* slot, const float* xs,
                                 const float* ys, const float* pix,
                                 const float* tables, const int* starts,
                                 int n, int C, float* out, void* stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(slot) |
                     reinterpret_cast<uintptr_t>(xs) |
                     reinterpret_cast<uintptr_t>(ys) |
                     reinterpret_cast<uintptr_t>(pix)) & 15) == 0;
  return launch_extents<LAYOUT>(slot, xs, ys, pix, tables, starts, n, C, vec,
                                out, (cudaStream_t)stream);
}
"""


def shim_libraries(kind: str, entries: str, layouts) -> dict:
    """The current ``csrc/lsd_fit.cu`` built once per fixed layout (a
    string of comma-separated template values), the builds side by side:
    a shim source under build/kernels_layouts/<hash>/ includes it and
    defines ``entries``, C entry points of its own that launch the
    template at ``LAYOUT``, so the package's source carries no build
    option.  Returns the loaded libraries by layout."""
    from line3dpp_tpu_torch.ops import kernels

    with open(LSD_FIT_CU, "rb") as f:
        h = hashlib.sha256(f.read() + entries.encode()).hexdigest()[:16]
    out_dir = os.path.join(REPO, "build", "kernels_layouts", h)
    os.makedirs(out_dir, exist_ok=True)
    libs, procs = {}, []
    for layout in layouts:
        stem = kind + "_" + "_".join(layout.split(","))
        libs[layout] = os.path.join(out_dir, stem + ".so")
        if not os.path.exists(libs[layout]):
            src = os.path.join(out_dir, stem + ".cu")
            with open(src, "w") as f:
                f.write(f'#include "{LSD_FIT_CU}"\n'
                        f"#define LAYOUT {layout}\n{entries}")
            procs.append(subprocess.Popen([
                kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src, "-o",
                libs[layout]]))
    if any(pr.wait() != 0 for pr in procs):
        chip_smoke.fail(f"a fixed {kind} layout did not build")
    return {k: ctypes.CDLL(v) for k, v in libs.items()}


def layout_libraries(layouts) -> dict:
    """K11 once per fixed layout ``THREADS,I,OVER,MINB``."""
    out = shim_libraries("k11", K11_FIXED, layouts)
    for lib in out.values():
        lib.l3d_extents_fixed.argtypes = [_P] * 6 + [_I] * 2 + [_P] + [_P]
        lib.l3d_extents_fixed.restype = ctypes.c_int
    return out


def k2_inputs(dev):
    """K2's arguments on the 26 views, from K1's match table."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import matching
    from line3dpp_tpu_torch.utils.testdata import load_views

    cfg = lt.Config(optimize=False)
    pipe = lt.Line3D(cfg, device="cpu")
    for v in load_views():
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    inp = pipe.step_inputs()
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
    pm = matching.match_pairs_cuda(t, cfg.epipolar_overlap, knn)
    args = chip_smoke.scoring_inputs(d, pm, cfg, knn)
    torch.cuda.synchronize()
    return args


def k11_grids(dev):
    """Round-1 inputs of facade view 0 and of the synthetic grids."""
    from line3dpp_tpu_torch.ops import lsd
    from line3dpp_tpu_torch.utils import synthetic

    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=3072, height=2304)[0]
    img, _ = lsd._prepare(synthetic.render(cam, quads, seed=100, ss=1), -1,
                          dev)
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    grids = {"facade view 0": (*lsd._grad_compact(img), (th, tw))}
    for frac in chip_smoke.FULL_SIZE_ACTIVE:
        grids[f"active {frac}"] = chip_smoke.synthetic_round1(frac, 0, dev)
    grids[f"stripes {chip_smoke.STRIPE_ACTIVE}"] = \
        chip_smoke.synthetic_stripes(chip_smoke.STRIPE_ACTIVE, 0, dev)
    return grids


def layout_turns(layouts, old, want, ok, rounds, slot, xs, ys, pix, tables,
                 starts, n, C) -> dict:
    """Each fixed layout's K11, bit-equal to the plain version, and the
    earlier kernel, timed in turns (forward, then backward): the mean
    device_ms of each."""
    import torch
    from line3dpp_tpu_torch.ops import kernels

    p, stream = kernels.ptr, kernels.stream(slot.device)
    outs = {k: torch.empty((C, 4), device=slot.device) for k in layouts}
    fns = {k: (lambda k=k, lib=lib: ok(lib.l3d_extents_fixed(
        p(slot), p(xs), p(ys), p(pix), p(tables), p(starts), n, C,
        p(outs[k]), stream), f"K11 layout {k}"))
        for k, lib in layouts.items()}
    fns["old"] = old
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    chip_smoke.check(all(torch.equal(x.view(torch.int32),
                                     want.view(torch.int32))
                         for x in outs.values()),
                     "K11: a layout differs from the plain version")
    times = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)] * rounds:
        times[k].append(chip_smoke.device_ms(fns[k], 20))
    return {k: sum(v) / len(v) for k, v in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="checkout holding the earlier kernel sources")
    ap.add_argument("--out", help="directory for k2_k11_turns.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also print each version's device time by kernel "
                         "(torch.profiler, 10 calls)")
    ap.add_argument("--k11-layouts", nargs="*", default=[],
                    metavar="THREADS,I,OVER,MINB",
                    help="also time these fixed K11 layouts of the current "
                         "source against the earlier kernel")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    from line3dpp_tpu_torch.ops import kernels, lsd, lsd_fit, scoring

    dev = torch.device("cuda")
    new = kernels.library()
    old = old_library(opts.old)
    layouts = layout_libraries(opts.k11_layouts)
    p = kernels.ptr
    stream = kernels.stream(dev)
    result = {"card": smi}

    def ok(rc, what):
        if rc != 0:
            chip_smoke.fail(f"{what}: CUDA error {rc}")

    # ---- K2 on the 26 views
    args, kw = k2_inputs(dev)
    V, S, M = args[7].shape
    N = args[5].shape[1]
    knn, tsa, ms = kw["knn"], kw["two_sig_a_sqr"], kw["min_similarity"]
    orient = int(kw["check_orientation"])
    cos_lo, lp = scoring.pretest_thresholds(tsa, ms)
    outs = {k: (torch.empty((V, S, M), device=dev),
                torch.empty((V, S, M), dtype=torch.bool, device=dev))
            for k in ("old", "new")}
    # the C interface takes d_p1, d_p2, valid first, then the rays and the
    # cameras
    ins = [p(a) for a in (*args[7:], *args[:7])]
    calls = {
        "old": lambda: ok(old.l3d_score_matches(
            *ins, V, S, M, N, knn, tsa, ms, orient,
            *(p(x) for x in outs["old"]), stream), "old K2"),
        "new": lambda: ok(new.l3d_score_matches(
            *ins, V, S, M, N, knn, tsa, ms, orient, cos_lo, lp,
            *(p(x) for x in outs["new"]), stream), "new K2")}
    for fn in calls.values():
        fn()
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
    print(f"K2: old and new equal bit for bit: {same} (score3d and valid; "
          f"{int(outs['new'][1].sum())} valid slots)", flush=True)
    chip_smoke.check(same, "K2: the new kernel differs from the old one")
    counts = chip_smoke.pretest_counts(*args, chunk=512, **kw)
    rates = dict(
        survivor_rate=counts["survivors"] / counts["pairs"],
        angle_keep_rate=counts["angle_keeps"] / counts["pairs"],
        depth_keep_rate=counts["depth_keeps"] / counts["pairs"],
        warp_step_survivor_rate=(counts["warp_steps_survivor"]
                                 / counts["warp_steps"]),
        partner_step_survivor_rate=(counts["partner_steps_survivor"]
                                    / counts["partner_steps"]))
    print(f"K2 pre-test: {json.dumps(counts)}; {json.dumps(rates)}",
          flush=True)
    result["k2"] = dict(turns(calls, opts.rounds, reps=5), equal=same,
                        **counts, **rates)
    if opts.profile:
        for k, fn in calls.items():
            print(f"K2 {k} by kernel (us): {json.dumps(by_kernel(fn, 3))}",
                  flush=True)
    r = result["k2"]
    print(f"K2: old {r['old']['device_ms_mean']:.4f} ms, new "
          f"{r['new']['device_ms_mean']:.4f} ms on the card", flush=True)
    del outs, args, ins
    torch.cuda.empty_cache()

    # ---- K11 on facade view 0 and the synthetic grids
    result["k11"] = {}
    for name, (angle, active, idx, mag_c, ang_c, tile) in \
            k11_grids(dev).items():
        pl = lsd._pixel_list(angle, active, idx, mag_c, ang_c, lsd.PREC,
                             tile)
        n, C = pl["n"], pl["C"]
        slot, xs, ys, starts = pl["slot"], pl["xs"], pl["ys"], pl["starts"]
        pix = torch.ones(n, device=dev)
        mom = lsd_fit.moments_plain(slot, xs, ys, pl["mag_s"], pix, C)
        tables = lsd._axis_tables(mom)[0]
        ext = {k: torch.empty((C, 4), device=dev) for k in ("old", "new")}
        calls = {
            "old": lambda: ok(old.l3d_extents(
                p(slot), p(xs), p(ys), p(pix), p(tables), n, C,
                p(ext["old"]), stream), "old K11"),
            "new": lambda: ok(new.l3d_extents(
                p(slot), p(xs), p(ys), p(pix), p(tables), p(starts), n, C,
                p(ext["new"]), stream), "new K11")}
        for fn in calls.values():
            fn()
            torch.cuda.synchronize()
        want = lsd_fit.extents_plain(slot, xs, ys, pix, tables, C)
        bits = lambda x: x.view(torch.int32)
        same = (torch.equal(bits(ext["old"]), bits(ext["new"]))
                and torch.equal(bits(ext["new"]), bits(want)))
        lengths = torch.bincount(slot.long(), minlength=C + 1)[:C]
        print(f"K11 {name}: {n} pixels, {C} components (longest "
              f"{int(lengths.max()) if C else 0}); old, new and plain "
              f"equal bit for bit: {same}", flush=True)
        chip_smoke.check(same, f"K11 on {name}: the new kernel differs")
        result["k11"][name] = dict(
            turns(calls, opts.rounds, reps=20), pixels=n, components=C,
            longest_run=int(lengths.max()) if C else 0)
        if opts.profile:
            for k, fn in calls.items():
                print(f"K11 {name} {k} by kernel (us): "
                      f"{json.dumps(by_kernel(fn))}", flush=True)
        r = result["k11"][name]
        print(f"K11 {name}: old {r['old']['device_ms_mean']:.5f} ms, new "
              f"{r['new']['device_ms_mean']:.5f} ms on the card", flush=True)
        if layouts:
            r["layouts"] = layout_turns(layouts, calls["old"], want, ok,
                                        opts.rounds, slot, xs, ys, pix,
                                        tables, starts, n, C)
            print(f"K11 {name} layouts, card ms: "
                  f"{json.dumps(r['layouts'])}", flush=True)

    line = json.dumps(result)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k2_k11_turns.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
