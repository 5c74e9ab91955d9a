#!/usr/bin/env python3
"""Kernels K1 and K4 against an earlier version of their sources, on one
GPU, in turns (old, new, new, old), on the inputs ``chip_smoke.py`` gives
them.

    python tests/measure_torch_k1_k4.py --old DIR [--out DIR] [--rounds 2]

``--old`` is a checkout of the tree whose ``line3dpp_tpu_torch/csrc/
matching.cu`` and ``lsd_cc.cu`` are the earlier kernels (for example
``mkdir -p build/old && git archive <commit> | tar -x -C build/old``); the
two sources are compiled there with the package's nvcc flags into a library
of their own and called through their plain C interfaces (the earlier
``l3d_match_pairs`` reads the (V, S, 4) segments, the earlier
``l3d_cc_tiles`` takes no patch).  Both versions launch on preallocated
outputs, so the times are the kernels' own: ``device_ms`` (calls queued
behind a sleep kernel, the card's time per call) and ``event_ms`` (CUDA
events around the calls, the host's launch included).  Their outputs must
be equal bit for bit.

Inputs: K1 on the 26 bundled views (S = 3000, 285 valid of 416 pairs,
k = 10); K4 on facade view 0 at 3072 x 2304 and on the synthetic 1920 x
2560 grids of ``chip_smoke.py`` (30 / 47 / 57% active, and the stripes at
47%) and on that grid with nothing active (the fixed cost).  Also counts, over all valid pairs of the 26 views, the candidates
that cross their target segment and reach an overlap of 0.25, and the warp
steps (32 source segments, one target) in which one lane does.  Prints one
JSON line and writes it to ``--out``/k1_k4_turns.json.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def old_library(old_root: str, same_abi: bool) -> ctypes.CDLL:
    """The earlier matching.cu and lsd_cc.cu, built once into
    build/kernels_old/<hash>/; ``same_abi``: their C interfaces are the
    current ones."""
    from line3dpp_tpu_torch.ops import kernels

    srcs = [os.path.join(old_root, "line3dpp_tpu_torch", "csrc", f)
            for f in ("matching.cu", "lsd_cc.cu")]
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
    cdll.l3d_match_pairs.argtypes = ([_P] * 13 + [_I] * 3 + [_F] + [_P] * 6
                                     + [_P])
    cdll.l3d_cc_tiles.argtypes = ([_P] * 2 + [_I] * (6 if same_abi else 4)
                                  + [_F] + [_P] * 2 + [_P])
    for fn in (cdll.l3d_match_pairs, cdll.l3d_cc_tiles):
        fn.restype = ctypes.c_int
    return cdll


def turns(versions: dict, rounds: int, reps: int) -> dict:
    """Times of each version's call, taken in the order old, new, new, old
    ``rounds`` times: per version the list of device_ms and event_ms."""
    order = ["old", "new", "new", "old"] * rounds
    out = {k: {"device_ms": [], "event_ms": []} for k in versions}
    for k in order:
        fn = versions[k]
        out[k]["device_ms"].append(chip_smoke.device_ms(fn, reps))
        out[k]["event_ms"].append(chip_smoke.cuda_ms(fn, reps))
    for k in out:
        for m in ("device_ms", "event_ms"):
            out[k][m + "_mean"] = float(np.mean(out[k][m]))
    return out


def k1_inputs(dev):
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
        "segments", "seg_mask", "RtKinv", "C", "neighbor_ids", "F",
        "pair_valid")}
    V, N = d["neighbor_ids"].shape
    src = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(N)
    t = matching.pair_tables(d["segments"], d["seg_mask"], d["RtKinv"],
                             d["C"], src, d["neighbor_ids"].reshape(-1),
                             d["F"].reshape(-1, 3, 3),
                             d["pair_valid"].reshape(-1))
    return t, cfg.epipolar_overlap, inp["knn"]


def k1_pass_rates(t, eo) -> dict:
    """Candidates (valid pair, unmasked source, unmasked target) that cross
    their target segment (inner >= -eps, outer_px >= 1) and that reach an
    overlap above ``eo``, and the warp steps in which one lane does."""
    import torch
    from line3dpp_tpu_torch.ops import matching

    eps = matching.EPS
    n = {"candidates": 0, "cross": 0, "overlap": 0, "warp_steps": 0,
         "warp_cross": 0, "warp_overlap": 0}
    S = t.mask.shape[1]
    Sp = -(-S // 32) * 32
    for p in torch.nonzero(t.pair_valid)[:, 0].tolist():
        s, g = int(t.src_idx[p]), int(t.tgt_idx[p])
        q = t.tq[g][None]
        e1, e2 = t.e1[p][:, None], t.e2[p][:, None]
        a1 = e1[..., 0] * q[..., 0] + e1[..., 1] * q[..., 1] + e1[..., 2]
        b1 = e1[..., 0] * q[..., 2] + e1[..., 1] * q[..., 3]
        a2 = e2[..., 0] * q[..., 0] + e2[..., 1] * q[..., 1] + e2[..., 2]
        b2 = e2[..., 0] * q[..., 2] + e2[..., 1] * q[..., 3]
        live = t.mask[s][:, None] & t.mask[g][None]
        z = (b1.abs() > eps) & (b2.abs() > eps)
        one = torch.ones_like(b1)
        t1 = -a1 / torch.where(z, b1, one)
        t2 = -a2 / torch.where(z, b2, one)
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        outer = hi.clamp_min(1.0) - lo.clamp_max(0.0)
        inner = hi.clamp_max(1.0) - lo.clamp_min(0.0)
        cross = live & z & (inner >= -eps) & (outer * t.seglen[g][None]
                                              >= 1.0)
        over = cross & (inner / outer.clamp_min(eps) > eo)
        n["candidates"] += int(live.sum())
        n["cross"] += int(cross.sum())
        n["overlap"] += int(over.sum())
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, Sp - S))
        steps = pad(live).reshape(Sp // 32, 32, S).any(1)
        n["warp_steps"] += int(steps.sum())
        n["warp_cross"] += int(pad(cross).reshape(Sp // 32, 32, S).any(1)
                               .sum())
        n["warp_overlap"] += int(pad(over).reshape(Sp // 32, 32, S).any(1)
                                 .sum())
    return n


def by_kernel(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each kernel (and memset) that
    ``calls`` runs of ``fn`` launch, from a torch.profiler trace."""
    _, events, _ = chip_smoke.device_events(
        lambda: [fn() for _ in range(calls)])
    out = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memset"):
            names = re.findall(r"([A-Za-z_]\w*(?:<[^(]*>)?)\(", e["name"])
            name = names[0] if names else e["name"][:40]
            out[name] = out.get(name, 0.0) + e["dur"] / calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="checkout holding the earlier kernel sources")
    ap.add_argument("--out", help="directory for k1_k4_turns.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--same-abi", action="store_true",
                    help="the --old sources have the current C interfaces")
    ap.add_argument("--profile", action="store_true",
                    help="also print each version's device time by kernel "
                         "(torch.profiler, 10 calls)")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    from line3dpp_tpu_torch.ops import kernels, lsd, lsd_cc
    from line3dpp_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    new = kernels.library()
    old = old_library(opts.old, opts.same_abi)
    p = kernels.ptr
    result = {"card": smi}

    def ok(rc, what):
        if rc != 0:
            chip_smoke.fail(f"{what}: CUDA error {rc}")

    # ---- K1 on the 26 views
    t, eo, knn = k1_inputs(dev)
    P, S = t.num_src.shape

    def k1_outputs():
        return [torch.zeros((P, S, knn), dtype=torch.int32, device=dev)] + [
            torch.zeros((P, S, knn), device=dev) for _ in range(5)]

    outs = {"old": k1_outputs(), "new": k1_outputs()}
    rest = [p(x) for x in (t.mask, t.r1, t.r2, t.n, t.seglen, t.e1, t.e2,
                           t.num_src, t.num_tgt, t.src_idx, t.tgt_idx,
                           t.pair_valid)]
    stream = kernels.stream(dev)
    calls = {
        "old": lambda: ok(old.l3d_match_pairs(
            p(t.tq if opts.same_abi else t.segments), *rest, P, S, knn, eo,
            *(p(x) for x in outs["old"]), stream), "old K1"),
        "new": lambda: ok(new.l3d_match_pairs(
            p(t.tq), *rest, P, S, knn, eo, *(p(x) for x in outs["new"]),
            stream), "new K1")}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
    print(f"K1: old and new equal bit for bit: {same}", flush=True)
    chip_smoke.check(same, "K1: the new kernel differs from the old one")
    rates = k1_pass_rates(t, eo)
    print(f"K1 candidates: {json.dumps(rates)}", flush=True)
    result["k1"] = dict(turns(calls, opts.rounds, reps=5), equal=same,
                        **rates)
    if opts.profile:
        for k, fn in calls.items():
            print(f"K1 {k} by kernel (us): {json.dumps(by_kernel(fn, 3))}",
                  flush=True)
    print(f"K1 times: {json.dumps(result['k1'])}", flush=True)
    del outs, t
    torch.cuda.empty_cache()

    # ---- K4 on facade view 0 and the synthetic grids
    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=3072, height=2304)[0]
    img, _ = lsd._prepare(synthetic.render(cam, quads, seed=100, ss=1), -1,
                          dev)
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    grids = {"facade view 0": lsd._grad_compact(img)[:2] + ((th, tw),)}
    for frac in chip_smoke.FULL_SIZE_ACTIVE:
        a = chip_smoke.synthetic_round1(frac, 0, dev)
        grids[f"active {frac}"] = (a[0], a[1], a[5])
    a = chip_smoke.synthetic_stripes(chip_smoke.STRIPE_ACTIVE, 0, dev)
    grids[f"stripes {chip_smoke.STRIPE_ACTIVE}"] = (a[0], a[1], a[5])
    # the fixed cost: the same grid with nothing active
    grids["nothing active"] = (a[0], torch.zeros_like(a[1]), a[5])
    tol = ctypes.c_float(float(np.float32(lsd.PREC)))
    result["k4"] = {}
    for name, (angle, active, tile) in grids.items():
        hp, wp = angle.shape
        ph, pw = lsd_cc.cc_patch(tile)
        lab = {k: torch.empty((hp, wp), dtype=torch.int32, device=dev)
               for k in ("old", "new")}
        unc = {k: torch.empty((1, 1), dtype=torch.int32, device=dev)
               for k in ("old", "new")}
        calls = {
            "old": lambda: ok(old.l3d_cc_tiles(
                p(angle), p(active), hp, wp, *tile,
                *((ph, pw) if opts.same_abi else ()), tol, p(lab["old"]),
                p(unc["old"]), stream), "old K4"),
            "new": lambda: ok(new.l3d_cc_tiles(
                p(angle), p(active), hp, wp, *tile, ph, pw, tol,
                p(lab["new"]), p(unc["new"]), stream), "new K4")}
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        same = torch.equal(lab["old"], lab["new"]) and int(
            unc["new"]) == 0
        n_active = int(active.sum())
        print(f"K4 {name}: {n_active} active of {hp * wp}; old and new "
              f"equal bit for bit: {same}", flush=True)
        chip_smoke.check(same, f"K4 on {name}: the new kernel differs")
        result["k4"][name] = dict(turns(calls, opts.rounds, reps=20),
                                  active=n_active / (hp * wp))
        if opts.profile:
            for k, fn in calls.items():
                print(f"K4 {name} {k} by kernel (us): "
                      f"{json.dumps(by_kernel(fn))}", flush=True)
        r = result["k4"][name]
        print(f"K4 {name}: old {r['old']['device_ms_mean']:.5f} ms, new "
              f"{r['new']['device_ms_mean']:.5f} ms on the card", flush=True)

    line = json.dumps(result)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k1_k4_turns.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
