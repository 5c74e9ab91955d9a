#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (line3dpp_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

1. Prints the card (``nvidia-smi`` name and power limit, device name and
   count); exits non-zero when no CUDA device is present.
2. Builds the CUDA kernels from ``line3dpp_tpu_torch/csrc`` (timed) and
   prints ptxas' register and spill report.
3. Loads the 26 bundled views and holds each kernel against its plain
   PyTorch version on the card at the main path's shapes (26 views,
   S = 3000, N = 16, k = 10, M = 160), timing both with CUDA events.
4. Drives the main path through the user entry points (``Line3D``,
   ``add_view``, ``match_images``, ``reconstruct_3d_lines``,
   ``save_txt/stl/obj``) with every launch counter reset just before and
   read just after; requires every kernel to have launched and the result to
   match ``testdata/out/...__vis_3.txt`` (2276 lines) within 1% of its line
   count and at count_f1 >= 0.99 (1% scene scale).
5. Prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.

``--out DIR`` writes the build log (and the profile) there; ``--profile``
adds a torch.profiler breakdown of one more ``match_images`` run.
"""

from __future__ import annotations

import argparse
import json
import os
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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12            # operations / s
PEAK_BYTES = 3.35e12        # bytes / s

# f32 operations per unit of work, counted from the kernels' source
K1_OPS_PER_CANDIDATE = 36   # 4 epipolar dots, 2 divisions, overlap (matching.cu)
K2_OPS_PER_PAIR = 40        # dot, acos, 3 exp, 2 divisions, min/max (scoring.cu)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
                   t.pair_valid) + nbytes(*got[:6])
    ms = cuda_ms(lambda: matching.match_pairs_cuda(t, eo, knn), reps=5)
    plain_ms = cuda_ms(lambda: matching.match_pairs_plain(t, eo, knn, 8),
                       reps=1)
    return got, (dict(
        name="K1 match_pairs", route="cuda",
        source="line3dpp_tpu_torch/csrc/matching.cu",
        replaces="line3dpp_tpu/ops/matching_pallas.py:233",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(ops / PEAK_F32, moved / PEAK_BYTES),
        bound_by="operations" if ops / PEAK_F32 > moved / PEAK_BYTES
        else "bytes", library_ms=None), candidates)


def check_k2(args, kw):
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

    ok = got.valid
    V, S, M = ok.shape
    N = args[5].shape[1]
    per_group = ok.reshape(V, S, N, M // N).sum(-1).long()
    pairs = int((per_group * (per_group.sum(-1, keepdim=True)
                              - per_group)).sum())
    ops = K2_OPS_PER_PAIR * pairs
    moved = nbytes(*args) + nbytes(got.score3d, got.valid)
    ms = cuda_ms(lambda: scoring.score_matches_cuda(*args, **kw), reps=5)
    plain_ms = cuda_ms(
        lambda: scoring.score_matches_plain(*args, chunk=2048, **kw), reps=1)
    return got, (dict(
        name="K2 score_matches", route="cuda",
        source="line3dpp_tpu_torch/csrc/scoring.cu",
        replaces="line3dpp_tpu/ops/scoring_pallas.py:231",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(ops / PEAK_F32, moved / PEAK_BYTES),
        bound_by="operations" if ops / PEAK_F32 > moved / PEAK_BYTES
        else "bytes", library_ms=None), pairs)


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
    return dict(
        name="K3 gather_target_estimates", route="cuda",
        source="line3dpp_tpu_torch/csrc/affinity_gather.cu",
        replaces="line3dpp_tpu/ops/affinity_pallas.py:76",
        max_abs_err=err,
        ms=cuda_ms(lambda: affinity.gather_target_estimates_cuda(
            table, est_valid, nbr32, ts32, knn), reps=20),
        plain_ms=cuda_ms(plain, reps=20),
        bound_ms=1e3 * moved / PEAK_BYTES, bound_by="bytes",
        library_ms=cuda_ms(library, reps=20))


def kernel_checks(inp, cfg, dev):
    """Each kernel against its plain version at the main path's shapes;
    K2 and K3 take the inputs the previous stages give them."""
    import torch
    from line3dpp_tpu_torch.models import step
    from line3dpp_tpu_torch.ops import affinity, geometry as geo, matching

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

    d_p1 = step.regroup(pm.d_p1, V, N).contiguous()
    d_p2 = step.regroup(pm.d_p2, V, N).contiguous()
    t_valid = step.regroup(pm.valid, V, N).contiguous()
    tgt_seg = step.regroup(pm.tgt_seg, V, N).contiguous()
    r1, r2 = geo.segment_rays(d["RtKinv"][:, None], d["segments"])
    mid = 0.5 * (d["segments"][..., 0:2] + d["segments"][..., 2:4])
    rmid = geo.rays_from_pixels(d["RtKinv"][:, None], mid)
    nbr = d["neighbor_ids"].long()
    args = (r1.contiguous(), r2.contiguous(), rmid.contiguous(), d["C"],
            d["k_reg"], d["C"][nbr].contiguous(), d["k_reg"][nbr].contiguous(),
            d_p1, d_p2, t_valid)
    kw = dict(knn=knn, two_sig_a_sqr=cfg.two_sig_a_sqr,
              min_similarity=cfg.min_similarity_3d,
              check_orientation=cfg.check_match_orientation)
    scored, (k2, pairs) = check_k2(args, kw)
    print(f"K2 work: {pairs} valid slot pairs", flush=True)

    fm = affinity.filter_matches(r1, r2, d["C"], scored.score3d,
                                 scored.valid, d_p1, d_p2,
                                 cfg.min_best_score_3d,
                                 cfg.min_best_score_perc)
    k3 = check_k3(fm, d["neighbor_ids"], tgt_seg, knn)
    return [k1, k2, k3]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for the build log and profile")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more match_images run")
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
    lib = kernels.library_path()
    kernels.library()
    native = clustering._native_lib() is not None
    build_s = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        build_log = f.read()
    print(f"kernels built in {build_s:.1f} s: {lib}; native union-find: "
          f"{native}", flush=True)
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    # ---- each kernel against its plain version at main-path shapes
    views = load_views()
    cfg = lt.Config(optimize=False)
    setup = lt.Line3D(cfg)
    for v in views:
        setup.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                       v.segments)
    rows = kernel_checks(setup.step_inputs(), cfg, dev)
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
        with open(base + ".txt") as f:
            n_rows = sum(1 for _ in f)
        with open(base + ".stl") as f:
            n_facets = sum(1 for r in f if r.startswith(" endfacet"))
    launches = dict(kernels.LAUNCHES)
    phases["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    print("main path: " + json.dumps(phases), flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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

    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "build.log"), "w") as f:
            f.write(build_log)
    if opts.profile:
        profile_match(pipe, opts.out)

    for r in rows:
        r["launches"] = launches[r["name"].split()[1]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def profile_match(pipe, out_dir) -> None:
    """Device time by kernel over one more match_images run, and the share
    of the profiled span in which the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.match_images()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out_dir or tmp, "match_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1.0
    for a, b in device:                    # union of device intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    # the span covers the torch ops; the wall time adds the host set-up
    # (neighbour choice, fundamental matrices) that precedes them
    print(f"profile: match_images wall {1e3 * wall:.3f} ms, torch-op span "
          f"{span / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / span:.1f}% of the span, "
          f"{busy / 1e4 / wall:.1f}% of the wall), {len(device)} device "
          f"events", flush=True)


if __name__ == "__main__":
    main()
