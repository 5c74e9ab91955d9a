#!/usr/bin/env python3
"""Kernel K10 (band_counts and its rescue form, rescue_counts) against the
rescue cascade's counting in an earlier version of the source, on one GPU,
in turns (old, new, new, old).

    python tests/measure_torch_k10.py --old DIR [--out DIR] [--rounds 2]
                                      [--profile] [--detect]
                                      [--layouts THREADS,I,MINB ...]

``--old`` is a checkout of the tree whose ``line3dpp_tpu_torch/csrc/
lsd_fit.cu`` holds the earlier K10 (a memset, the counting kernel with
integer atomics, an output pass) and K9; it is compiled with the package's
nvcc flags into a library of its own and called through its plain C
interface.

- The cascade's counts: the earlier K10 with the 15 rescue bands, then the
  p/2 retry as the earlier tree ran it (its gate table built in torch, K9's
  gate_pixels form at half the angle tolerance, a torch count of the kept
  pixels) against ``rescue_counts`` (one launch, the 16 columns), their
  counts checked equal; also the earlier K10 alone against the new kernel
  alone.
- The 4-band form (rect_improve's ``SYM_BANDS``): the earlier K10 against
  ``band_counts``, checked equal.
- Parts switched off: the new kernel with the 15 bands alone (no p/2
  column), with the 4 bands, with one band.

``device_ms`` is the card's time per call (calls queued behind a sleep
kernel), ``event_ms`` CUDA events around the calls, the host's share
included.  Inputs: facade view 0's rescue rounds as one detection at 3072 x
2304 with the rescue gives them, and the round-1 lists of the synthetic
1920 x 2560 grids of ``chip_smoke.py`` (30 / 47 / 57% active, and the
stripes at 47%) with the first fit's rectangles, as ``chip_smoke.py``
checks them.  ``--profile`` adds each version's device time by kernel
(torch.profiler, 10 calls); ``--layouts`` times fixed layouts of the rescue
form and of the 4-band form (``launch_counts<HALF, NB, THREADS, I,
MINB>``: threads a block, pixels a lane, blocks an SM at least; built
through a shim source, ``measure_torch_k2_k11.shim_libraries``), their
counts checked equal.  ``--detect`` profiles one detection of facade view 0, plain and
with the rescue cascade, on this tree and on ``--old``'s (each in a process
of its own, in turns): wall time, device busy time, device events and host
syncs.  Also prints the registers of the kernels (``ptxas -v`` of the
package's build).  Prints one JSON line and writes it to
``--out``/k10_turns.json.
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
from measure_torch_k6_k9 import detect_turns  # noqa: E402

_P, _I, _L, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint, ctypes.c_float)

# the rescue form and the 4-band form at a fixed layout LAYOUT = THREADS,
# I, MINB, with the arguments of l3d_band_counts
K10_FIXED = r"""
extern "C" int l3d_counts_fixed(
    const int* slot, const float* xs, const float* ys, const float* ang,
    const float* pix, const float* tables, const float* bands,
    const int* starts, int n, int C, int B, int half, float cos_tol,
    unsigned long long* words, int64_t words_len, unsigned epoch,
    float* out, void* stream) {
  if (C == 0) return 0;
  const CountArgs a = count_args(slot, xs, ys, ang, pix, tables, bands,
                                 starts, n, C, B, half, cos_tol, words, epoch,
                                 out);
  if (half) return launch_counts<true, 16, LAYOUT>(a, (cudaStream_t)stream);
  return launch_counts<false, 4, LAYOUT>(a, (cudaStream_t)stream);
}
"""


def old_library(old_root: str) -> ctypes.CDLL:
    """The earlier lsd_fit.cu, built once into build/kernels_k10/<hash>/."""
    from line3dpp_tpu_torch.ops import kernels

    src = os.path.join(old_root, "line3dpp_tpu_torch", "csrc", "lsd_fit.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(REPO, "build", "kernels_k10", h)
    lib = os.path.join(out_dir, "lib.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src,
                        "-o", lib], check=True)
    old = ctypes.CDLL(lib)
    # slot xs ys pix tables bands, n C B, scratch out, stream
    old.l3d_band_counts.argtypes = [_P] * 6 + [_I] * 3 + [_P] * 2 + [_P]
    old.l3d_gate_pixels.argtypes = [_P] * 6 + [_I] * 3 + [_F] + [_P] + [_P]
    for fn in (old.l3d_band_counts, old.l3d_gate_pixels):
        fn.restype = ctypes.c_int
    return old


def layout_libraries(layouts) -> dict:
    out = shim_libraries("k10", K10_FIXED, layouts)
    for lib in out.values():
        lib.l3d_counts_fixed.argtypes = ([_P] * 8 + [_I] * 4 + [_F]
                                         + [_P, _L, _U] + [_P] + [_P])
        lib.l3d_counts_fixed.restype = ctypes.c_int
    return out


def count_inputs(slot, xs, ys, ang, pix, tables, C, starts) -> dict:
    return dict(slot=slot, xs=xs, ys=ys, ang=ang, pix=pix, tables=tables,
                C=C, starts=starts)


def facade_rounds(dev) -> dict:
    """The arguments of ``rescue_counts`` in the three rounds of one
    detection of facade view 0 with the rescue cascade."""
    import torch
    from line3dpp_tpu_torch.ops import lsd, lsd_fit
    from line3dpp_tpu_torch.utils import synthetic

    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=3072, height=2304)[0]
    img, _ = lsd._prepare(synthetic.render(cam, quads, seed=100, ss=1), -1,
                          dev)
    calls = []
    orig = lsd_fit.rescue_counts

    def record(slot, xs, ys, ang, pix, tables, C, bands, cos_tol, starts):
        calls.append(count_inputs(*(t.clone() for t in (slot, xs, ys, ang,
                                                         pix, tables)), C,
                                  starts.clone()))
        return orig(slot, xs, ys, ang, pix, tables, C, bands, cos_tol,
                    starts)

    lsd_fit.rescue_counts = record
    try:
        lsd._lsd_core(img, rescue=True)
    finally:
        lsd_fit.rescue_counts = orig
    torch.cuda.synchronize()
    return {f"facade view 0, round {r}": c for r, c in enumerate(calls, 1)}


def grid_inputs(dev) -> dict:
    """Per synthetic grid, its round-1 list with the first fit's
    rectangles' band tables, every pixel with pix = 1."""
    import torch
    from line3dpp_tpu_torch.ops import lsd, lsd_fit

    grids = {f"active {frac}": chip_smoke.synthetic_round1(frac, 0, dev)
             for frac in chip_smoke.FULL_SIZE_ACTIVE}
    grids[f"stripes {chip_smoke.STRIPE_ACTIVE}"] = \
        chip_smoke.synthetic_stripes(chip_smoke.STRIPE_ACTIVE, 0, dev)
    out = {}
    for name, (angle, active, idx, mag_c, ang_c, tile) in grids.items():
        pl = lsd._pixel_list(angle, active, idx, mag_c, ang_c, lsd.PREC, tile)
        slot, xs, ys, C = pl["slot"], pl["xs"], pl["ys"], pl["C"]
        ones = torch.ones(pl["n"], device=dev)
        mom = lsd_fit.moments_plain(slot, xs, ys, pl["mag_s"], ones, C)
        tables, npix, _ = lsd._axis_tables(mom)
        f = lsd._rectangles(tables, npix, lsd_fit.extents_plain(
            slot, xs, ys, ones, tables, C))
        out[name] = count_inputs(slot, xs, ys, pl["ang_s"], ones,
                                 lsd._band_tables(f), C, pl["starts"])
    return out


def registers() -> list[str]:
    """ptxas' lines of the K10 kernels in the package's build."""
    from line3dpp_tpu_torch.ops import kernels

    lib = kernels.library_path()
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        log = f.read()
    return [line for line in chip_smoke.ptxas_report(log)
            if "counts_kernel" in line]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="checkout holding the earlier kernel sources")
    ap.add_argument("--out", help="directory for k10_turns.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also print each version's device time by kernel "
                         "(torch.profiler, 10 calls)")
    ap.add_argument("--detect", action="store_true",
                    help="also profile one detection of facade view 0 on "
                         "both trees")
    ap.add_argument("--layouts", nargs="*", default=[],
                    metavar="THREADS,I,MINB",
                    help="also time these fixed layouts of both forms")
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
    kernels.library()
    result = {"card": smi, "registers": registers()}
    for line in result["registers"]:
        print("ptxas: " + line, flush=True)
    old = old_library(opts.old)
    fixed = layout_libraries(opts.layouts)
    p, stream = kernels.ptr, kernels.stream(dev)

    def ok(rc, what):
        if rc != 0:
            chip_smoke.fail(f"{what}: CUDA error {rc}")

    cases = facade_rounds(dev)
    cases.update(grid_inputs(dev))
    rescue = torch.tensor(lsd.RESCUE_BANDS, dtype=torch.float32, device=dev)
    sym = torch.tensor(lsd_fit.SYM_BANDS, dtype=torch.float32, device=dev)
    for name, a in cases.items():
        slot, xs, ys, ang, pix, tab = (a[k] for k in ("slot", "xs", "ys",
                                                      "ang", "pix", "tables"))
        C, starts, n = a["C"], a["starts"], a["slot"].numel()
        scratch = torch.empty((C, 16), dtype=torch.int32, device=dev)
        outs = {k: torch.empty((C, b), dtype=torch.float32, device=dev)
                for k, b in (("old15", 15), ("old4", 4))}
        half_pix = torch.empty_like(xs)

        def old_k10(bands, out):
            ok(old.l3d_band_counts(p(slot), p(xs), p(ys), p(pix), p(tab),
                                   p(bands), n, C, bands.shape[0],
                                   p(scratch), p(out), stream), "old K10")
            return out

        def old_cascade():
            # the earlier tree's counting in _rescue: K10 with the 15
            # bands, the p/2 table, K9's gate_pixels form, the count
            counts = old_k10(rescue, outs["old15"])
            width, mid = tab[:, 5], tab[:, 4]
            half = tab.clone()
            half[:, 4] = torch.where(width > 0, 0.5 * width, -1.0)
            half[:, 5] = mid
            ok(old.l3d_gate_pixels(p(slot), p(xs), p(ys), p(ang), p(pix),
                                   p(half), n, C, 0,
                                   ctypes.c_float(lsd.COS_GATE_HALF),
                                   p(half_pix), stream), "old K9")
            acc = torch.zeros((C + 1,), dtype=torch.int32, device=dev)
            acc.index_add_(0, slot.long(), (half_pix != 0.0).to(torch.int32))
            return counts, acc[:C].to(torch.float32)

        def new_kernel(bands, half):
            if half:
                return lsd_fit.rescue_counts_cuda(
                    slot, xs, ys, ang, pix, tab, C, bands, lsd.COS_GATE_HALF,
                    starts)
            return lsd_fit.band_counts_cuda(slot, xs, ys, pix, tab, C, bands,
                                            starts)

        new = lsd_fit.rescue_counts_cuda(slot, xs, ys, ang, pix, tab, C,
                                         rescue, lsd.COS_GATE_HALF, starts)
        counts, k_half = old_cascade()
        new4 = lsd_fit.band_counts_cuda(slot, xs, ys, pix, tab, C, sym,
                                        starts)
        was4 = old_k10(sym, outs["old4"])
        torch.cuda.synchronize()
        plain = lsd_fit.rescue_counts_plain(slot, xs, ys, ang, pix, tab, C,
                                            rescue, lsd.COS_GATE_HALF)
        same = (torch.equal(new[:, 0], k_half)
                and torch.equal(new[:, 1:], counts)
                and torch.equal(new, plain) and torch.equal(new4, was4))
        chip_smoke.check(same, f"{name}: K10 differs from the earlier "
                               f"counting or its plain version")
        n_real = int((slot < C).sum())
        n_ang = chip_smoke.half_band_pixels(slot, xs, ys, pix, tab, C)
        cascade = {"old": old_cascade,
                   "new": lambda: lsd_fit.rescue_counts_cuda(
                       slot, xs, ys, ang, pix, tab, C, rescue,
                       lsd.COS_GATE_HALF, starts)}
        kernel = {"old": lambda: old_k10(rescue, outs["old15"]),
                  "new": lambda: new_kernel(rescue, True)}
        four = {"old": lambda: old_k10(sym, outs["old4"]),
                "new": lambda: lsd_fit.band_counts_cuda(
                    slot, xs, ys, pix, tab, C, sym, starts)}
        parts = {
            "16 columns": lambda: new_kernel(rescue, True),
            "15 bands, no p/2": lambda: new_kernel(rescue, False),
            "4 bands": lambda: new_kernel(sym, False),
            "1 band": lambda: new_kernel(sym[:1], False)}
        r = dict(
            pixels=n, components=C, real_pixels=n_real, half_band=n_ang,
            equal=same,
            bound_ms=chip_smoke.bound(
                chip_smoke.K9_OPS_PER_PIXEL * n_ang
                + (chip_smoke.K10_OPS_PER_PIXEL
                   + 15 * chip_smoke.K10_OPS_PER_BAND) * n_real,
                chip_smoke.count_bytes(slot, xs, ys, pix, tab, rescue, new,
                                       n_ang))[0],
            bound4_ms=chip_smoke.bound(
                (chip_smoke.K10_OPS_PER_PIXEL
                 + 4 * chip_smoke.K10_OPS_PER_BAND) * n_real,
                chip_smoke.count_bytes(slot, xs, ys, pix, tab, sym, new4,
                                       0))[0],
            cascade=turns(cascade, opts.rounds, reps=20),
            cascade_device_sum_ms={k: chip_smoke.device_sum_ms(fn)
                                   for k, fn in cascade.items()},
            kernel=turns(kernel, opts.rounds, reps=20),
            four_bands=turns(four, opts.rounds, reps=20),
            parts={k: chip_smoke.device_ms(fn, 20)
                   for k, fn in parts.items()})
        t, k4 = r["cascade"], r["four_bands"]
        print(f"{name}: {n} pixels, {C} components; the cascade's counts "
              f"{t['old']['device_ms_mean']:.5f} -> "
              f"{t['new']['device_ms_mean']:.5f} ms on the card (per call "
              f"{t['old']['event_ms_mean']:.5f} -> "
              f"{t['new']['event_ms_mean']:.5f} ms), bound "
              f"{r['bound_ms']:.5f} ms; 4 bands "
              f"{k4['old']['device_ms_mean']:.5f} -> "
              f"{k4['new']['device_ms_mean']:.5f} ms, bound "
              f"{r['bound4_ms']:.5f} ms; parts {json.dumps(r['parts'])}",
              flush=True)
        if opts.profile:
            for k, fn in cascade.items():
                print(f"{name} cascade {k} by kernel (us): "
                      f"{json.dumps(by_kernel(fn))}", flush=True)
        if fixed:
            res = {}
            for layout, lib in fixed.items():
                for form, bands, half, want in (("16", rescue, 1, new),
                                                ("4", sym, 0, new4)):
                    out = torch.empty_like(want)

                    def call(lib=lib, out=out, bands=bands, half=half):
                        # words for the shortest span, 4 pixels a lane
                        words, epoch = lsd_fit._status_words(
                            "counts_fixed", dev, stream.value,
                            -(-n // 128) * lsd_fit.MAX_BANDS // 2)
                        ok(lib.l3d_counts_fixed(
                            p(slot), p(xs), p(ys), p(ang), p(pix), p(tab),
                            p(bands), p(starts), n, C, bands.shape[0], half,
                            ctypes.c_float(lsd.COS_GATE_HALF), p(words),
                            words.numel(), epoch, p(out), stream),
                           f"layout {layout}")

                    call()
                    torch.cuda.synchronize()
                    chip_smoke.check(torch.equal(out, want),
                                     f"{name}: layout {layout} differs")
                    res[f"{form} columns {layout}"] = chip_smoke.device_ms(
                        call, 20)
            r["layouts"] = res
            print(f"{name} layouts, card ms: {json.dumps(res)}", flush=True)
        result[name] = r
        torch.cuda.empty_cache()

    if opts.detect:
        result["detect"] = detect_turns(opts.old, opts.rounds)
        print(f"detection of facade view 0: {json.dumps(result['detect'])}",
              flush=True)
    line = json.dumps(result)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k10_turns.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
