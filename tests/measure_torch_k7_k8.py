#!/usr/bin/env python3
"""Kernels K7 (moments) and K8 (gate_moments) against an earlier version
of their source, on one GPU, in turns (old, new, new, old), on the inputs
``chip_smoke.py`` gives them.

    python tests/measure_torch_k7_k8.py --old DIR [--out DIR] [--rounds 2]
                                        [--profile]
                                        [--layouts THREADS,MINB,STAGES ...]

``--old`` is a checkout of the tree whose ``line3dpp_tpu_torch/csrc/
lsd_fit.cu`` holds the earlier kernels (for example ``mkdir -p build/old &&
git archive <commit> | tar -x -C build/old``); that source is compiled with
the package's nvcc flags into a library of its own and called through its
plain C interface (the earlier ``l3d_moments`` and ``l3d_gate_moments``
take a float64 scratch and no run table).  Both versions launch on
preallocated outputs, so the times are the kernels' own: ``device_ms``
(calls queued behind a sleep kernel, the card's time per call) and
``event_ms`` (CUDA events around the calls, the host's launch included).

Inputs: facade view 0's round-1 list at 3072 x 2304 and the synthetic
1920 x 2560 grids of ``chip_smoke.py`` (30 / 47 / 57% active, and the
stripes at 47%), all pixels counted for K7, and for K8 the first refine
step's gate on the first fit, as ``chip_smoke.py`` checks them.  Checks the
new kernels against the plain versions (relative error <= 1e-6, K8's
newpix equal to K9's) and two calls of each version against each other
bit for bit, and K9's gate of both versions bit for bit; counts the float32
results that differ between the versions and by how many units in the last
place.  ``--profile`` adds each
version's device time by kernel (torch.profiler, 10 calls);
``--layouts`` times fixed layouts of the new kernels
(``launch_fit_layout<GATE, THREADS, MINB, STAGES>`` of ``csrc/lsd_fit.cu``:
threads a block, least blocks an SM, tiles in the shared buffer; built
through a shim source, ``measure_torch_k2_k11.shim_libraries``) on each
input.
Prints one JSON line and writes it to ``--out``/k7_k8_turns.json.
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
from measure_torch_k2_k11 import k11_grids, shim_libraries  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# K7 and K8 at a fixed layout LAYOUT = THREADS, MINB, STAGES, with the
# arguments of l3d_moments and l3d_gate_moments but the threads
K78_FIXED = r"""
extern "C" int l3d_moments_fixed(const int* slot, const float* xs,
                                 const float* ys, const float* mag,
                                 const float* pix, const int* starts, int n,
                                 int C, float* out, void* stream) {
  return launch_fit_layout<false, LAYOUT>(
      {slot, xs, ys, nullptr, mag, pix, nullptr, starts, nullptr, out, n, 0,
       0, C, 0, 0, 0.f}, (cudaStream_t)stream);
}
extern "C" int l3d_gate_moments_fixed(
    const int* slot, const float* xs, const float* ys, const float* ang,
    const float* mag, const float* pix, const float* tables,
    const int* starts, int n, int C, int dump_keep, float cos_tol,
    float* newpix, float* out, void* stream) {
  return launch_fit_layout<true, LAYOUT>(
      {slot, xs, ys, ang, mag, pix, reinterpret_cast<const float4*>(tables),
       starts, newpix, out, n, 0, 0, C, 0, dump_keep, cos_tol},
      (cudaStream_t)stream);
}
"""


def libraries(old_root: str, layouts) -> dict:
    """The earlier lsd_fit.cu, built into build/kernels_k78/<hash>/, and the
    current one per fixed layout ``THREADS,MINB,STAGES``."""
    from line3dpp_tpu_torch.ops import kernels

    src = os.path.join(old_root, "line3dpp_tpu_torch", "csrc", "lsd_fit.cu")
    with open(src, "rb") as f:
        out_dir = os.path.join(REPO, "build", "kernels_k78",
                               hashlib.sha256(f.read()).hexdigest()[:16])
    lib = os.path.join(out_dir, "lib.so")
    build = None
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        build = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS,
                                  "-shared", src, "-o", lib])
    libs = shim_libraries("k78", K78_FIXED, layouts)
    if build is not None and build.wait() != 0:
        chip_smoke.fail("the earlier K7/K8 library did not build")
    old = libs["old"] = ctypes.CDLL(lib)
    old.l3d_moments.argtypes = [_P] * 5 + [_I] * 2 + [_P] * 2 + [_P]
    old.l3d_gate_moments.argtypes = ([_P] * 7 + [_I] * 3 + [_F] + [_P] * 3
                                     + [_P])
    old.l3d_gate_pixels.argtypes = [_P] * 6 + [_I] * 3 + [_F] + [_P] + [_P]
    for fn in (old.l3d_moments, old.l3d_gate_moments, old.l3d_gate_pixels):
        fn.restype = ctypes.c_int
    for layout in layouts:
        fixed = libs[layout]
        fixed.l3d_moments_fixed.argtypes = [_P] * 6 + [_I] * 2 + [_P] + [_P]
        fixed.l3d_gate_moments_fixed.argtypes = ([_P] * 8 + [_I] * 3 + [_F]
                                                 + [_P] * 2 + [_P])
        fixed.l3d_moments_fixed.restype = ctypes.c_int
        fixed.l3d_gate_moments_fixed.restype = ctypes.c_int
    return libs


def ulps(a, b) -> dict:
    """How many float32 results differ, and by at most how many units in
    the last place (all sums are >= 0, so the int32 views order them)."""
    import torch

    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return dict(differ=int((d > 0).sum()), of=d.numel(),
                max_ulps=int(d.max()) if d.numel() else 0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="checkout holding the earlier kernel source")
    ap.add_argument("--out", help="directory for k7_k8_turns.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also print each version's device time by kernel "
                         "(torch.profiler, 10 calls)")
    ap.add_argument("--layouts", nargs="*", default=[],
                    metavar="THREADS,MINB,STAGES",
                    help="also time these fixed layouts of the new kernels")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    from line3dpp_tpu_torch.ops import kernels, lsd, lsd_fit

    dev = torch.device("cuda")
    libs = libraries(opts.old, opts.layouts)
    libs["new"] = kernels.library()
    p, stream = kernels.ptr, kernels.stream(dev)
    result = {"card": smi}

    def ok(rc, what):
        if rc != 0:
            chip_smoke.fail(f"{what}: CUDA error {rc}")

    def rel_err(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) \
            if a.numel() else 0.0

    for name, (angle, active, idx, mag_c, ang_c, tile) in \
            k11_grids(dev).items():
        pl = lsd._pixel_list(angle, active, idx, mag_c, ang_c, lsd.PREC,
                             tile)
        n, C = pl["n"], pl["C"]
        slot, xs, ys, starts = pl["slot"], pl["xs"], pl["ys"], pl["starts"]
        mag, ang = pl["mag_s"], pl["ang_s"]
        pix = torch.ones(n, device=dev)
        mom_p = lsd_fit.moments_plain(slot, xs, ys, mag, pix, C)
        tables, npix, _ = lsd._axis_tables(mom_p)
        f = lsd._rectangles(tables, npix,
                            lsd_fit.extents_plain(slot, xs, ys, pix, tables,
                                                  C))
        t8 = lsd._with_gate(f, lsd._refine_gate(f)[0])
        cos_gate = lsd.COS_GATE
        np9 = lsd_fit.gate_pixels_cuda(slot, xs, ys, ang, pix, t8, True,
                                       cos_gate, C)
        mom8_p = lsd_fit.moments_plain(slot, xs, ys, mag, np9, C)
        scratch = torch.empty((C, 7), dtype=torch.float64, device=dev)
        outs = {k: (torch.empty((C, 8), device=dev),
                    torch.empty(n, device=dev), torch.empty((C, 8),
                                                            device=dev))
                for k in libs}

        threads = lsd_fit.fit_threads(n, C)

        def k7(k, lib):
            head = (p(slot), p(xs), p(ys), p(mag), p(pix))
            if k == "old":
                return lambda: ok(lib.l3d_moments(
                    *head, n, C, p(scratch), p(outs[k][0]), stream),
                    "old K7")
            if k == "new":
                return lambda: ok(lib.l3d_moments(
                    *head, p(starts), n, C, threads, p(outs[k][0]), stream),
                    "new K7")
            return lambda: ok(lib.l3d_moments_fixed(
                *head, p(starts), n, C, p(outs[k][0]), stream), f"{k} K7")

        def k8(k, lib):
            head = (p(slot), p(xs), p(ys), p(ang), p(mag), p(pix), p(t8))
            tail = (p(outs[k][1]), p(outs[k][2]), stream)
            if k == "old":
                return lambda: ok(lib.l3d_gate_moments(
                    *head, n, C, 1, cos_gate, p(outs[k][1]), p(scratch),
                    p(outs[k][2]), stream), "old K8")
            if k == "new":
                return lambda: ok(lib.l3d_gate_moments(
                    *head, p(starts), n, C, threads, 1, cos_gate, *tail),
                    "new K8")
            return lambda: ok(lib.l3d_gate_moments_fixed(
                *head, p(starts), n, C, 1, cos_gate, *tail), f"{k} K8")

        calls7 = {k: k7(k, lib) for k, lib in libs.items()}
        calls8 = {k: k8(k, lib) for k, lib in libs.items()}
        r = dict(pixels=n, components=C,
                 longest_run=int(torch.bincount(slot.long(), minlength=C + 1)
                                 [:C].max()) if C else 0)
        # every version against the plain one, and against itself
        for k in libs:
            calls7[k]()
            calls8[k]()
            first = [x.clone() for x in outs[k]]
            calls7[k]()
            calls8[k]()
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(first, outs[k]))
            r[k] = dict(rel_err_k7=rel_err(outs[k][0], mom_p),
                        rel_err_k8=rel_err(outs[k][2], mom8_p),
                        newpix_equals_k9=torch.equal(outs[k][1], np9),
                        repeat_bit_equal=same)
            if k != "old":
                chip_smoke.check(
                    r[k]["rel_err_k7"] <= 1e-6 and r[k]["rel_err_k8"] <= 1e-6
                    and r[k]["newpix_equals_k9"] and same,
                    f"K7/K8 {k} on {name}: {r[k]}")
        # the gate the two share: K9 of both versions on K8's inputs
        np9_old = torch.empty(n, device=dev)
        ok(libs["old"].l3d_gate_pixels(
            p(slot), p(xs), p(ys), p(ang), p(pix), p(t8), n, C, 1, cos_gate,
            p(np9_old), stream), "old K9")
        torch.cuda.synchronize()
        r["k9_new_equals_old"] = torch.equal(np9, np9_old)
        chip_smoke.check(r["k9_new_equals_old"],
                         f"K9 on {name}: the gate differs from the old one")
        r["k7_new_vs_old"] = ulps(outs["new"][0], outs["old"][0])
        r["k8_new_vs_old"] = ulps(outs["new"][2], outs["old"][2])
        r["k7_new_vs_plain"] = ulps(outs["new"][0], mom_p)
        r["k7_old_vs_plain"] = ulps(outs["old"][0], mom_p)
        print(f"{name}: {n} pixels, {C} components (longest "
              f"{r['longest_run']}); {json.dumps(r)}", flush=True)
        versions = ("old", "new")
        r["k7"] = turns({k: calls7[k] for k in versions}, opts.rounds,
                        reps=20)
        r["k8"] = turns({k: calls8[k] for k in versions}, opts.rounds,
                        reps=20)
        print(f"{name}: K7 old {r['k7']['old']['device_ms_mean']:.5f} new "
              f"{r['k7']['new']['device_ms_mean']:.5f} ms, K8 old "
              f"{r['k8']['old']['device_ms_mean']:.5f} new "
              f"{r['k8']['new']['device_ms_mean']:.5f} ms on the card",
              flush=True)
        if opts.profile:
            for k in versions:
                print(f"{name} {k} K7 by kernel (us): "
                      f"{json.dumps(by_kernel(calls7[k]))}; K8: "
                      f"{json.dumps(by_kernel(calls8[k]))}", flush=True)
        if opts.layouts:
            r["layouts"] = {}
            for k in [*opts.layouts, "new"]:
                r["layouts"][k] = dict(
                    k7=chip_smoke.device_ms(calls7[k], 20),
                    k8=chip_smoke.device_ms(calls8[k], 20))
            print(f"{name} layouts, card ms: {json.dumps(r['layouts'])}",
                  flush=True)
        result[name] = r
        del outs, scratch
        torch.cuda.empty_cache()

    line = json.dumps(result)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k7_k8_turns.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
