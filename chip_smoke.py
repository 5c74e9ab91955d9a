#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (line3dpp_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

1. Prints the card (``nvidia-smi`` name and power limit, device name and
   count); exits non-zero when no CUDA device is present.
2. Builds the CUDA kernels from ``line3dpp_tpu_torch/csrc`` (timed) and
   prints ptxas' register and spill report.
3. Cached segments to lines: loads the 26 bundled views and holds kernels
   K1-K3 against their plain PyTorch versions on the card at that path's
   shapes (26 views, S = 3000, N = 16, k = 10, M = 160), timing both with
   CUDA events; then drives the path through the user entry points
   (``Line3D``, ``add_view``, ``match_images``, ``reconstruct_3d_lines``,
   ``save_txt/stl/obj``) with every launch counter reset just before and
   read just after; requires K1-K3 to have launched and the result to
   match ``testdata/out/...__vis_3.txt`` (2276 lines) within 1% of its line
   count and at count_f1 >= 0.99 (1% scene scale).
4. Images to lines: renders the 10 views of the synthetic facade at
   3072 x 2304 (``utils/synthetic``), checks them against the digests of
   ``tests/data/torch_scene2_3072_jax_reference.npz`` (written by
   ``tests/make_torch_lsd_reference.py`` with the JAX package on the CPU),
   holds the detection kernels K4-K9 and K11 against their plain versions
   on view 0's round-1 inputs and on synthetic full-size grids at a real
   photo's density (``FULL_SIZE_ACTIVE``), compares every view's
   detections with the JAX ones (``DETECT_*``), reconstructs from JAX's
   detections (JAX's lines at count_f1 >= 0.99, and count_f1, recall and
   precision against the 74 ground-truth lines within 0.02 of JAX's), and
   drives ``Line3D`` -> ``add_images`` -> ``match_images`` ->
   ``reconstruct_3d_lines`` -> ``save_*`` with the counters reset and read
   around it; requires every kernel to have launched and the ground-truth
   metrics within ``GT_SPREAD`` of JAX's.
5. Prints one ``{"full_size": ...}`` line (the detection kernels on the
   synthetic grids), one ``{"kernels": [...]}`` line, the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.  Any failed check exits
   non-zero.

``--out DIR`` writes the build log (and the profiles) there; ``--profile``
adds a torch.profiler breakdown of one more ``match_images`` run and of
the detection of one facade view.
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
SCENE2_NPZ = os.path.join(REPO, "tests", "data",
                          "torch_scene2_3072_jax_reference.npz")

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12            # operations / s
PEAK_BYTES = 3.35e12        # bytes / s

# f32 operations per unit of work, counted from the kernels' source
K1_OPS_PER_CANDIDATE = 36   # 4 epipolar dots, 2 divisions, overlap (matching.cu)
K2_OPS_PER_PAIR = 40        # dot, acos, 3 exp, 2 divisions, min/max (scoring.cu)
K4_OPS_PER_ACTIVE = 16      # 4 backward links x angle_diff (lsd_cc.cu)
K7_OPS_PER_PIXEL = 13       # 6 products, 7 sums (lsd_fit.cu)
K9_OPS_PER_PIXEL = 50       # cosf, sinf (~20 each), projection, 3 tests
K11_OPS_PER_PIXEL = 14      # 2 differences, 2 projections, 4 minima

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
# active share of the synthetic full-size grids: real photos' round 1
# (30-47%), and 57% for a 2.8 M-pixel list (the JAX package's cap NC)
FULL_SIZE_ACTIVE = (0.30, 0.47, 0.57)


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


def bound(ops: float, moved: float) -> tuple[float, str]:
    """Least time on the card in ms, and what bounds it."""
    t_ops, t_bytes = ops / PEAK_F32, moved / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def kernel_row(name, source, replaces, err, ms, plain_ms, ops, moved,
               library_ms=None) -> dict:
    b_ms, by = bound(ops, moved)
    return dict(name=name, route="cuda",
                source=f"line3dpp_tpu_torch/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=library_ms)


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


def check_lsd_kernels(angle, active, idx, mag_c, ang_c, tile, dev,
                      what: str):
    """K4-K9 and K11 against their plain versions on one grid's round-1
    inputs, with times and bounds."""
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
        cuda_ms(lambda: lsd_cc.cc_tiles_cuda(angle, active, tol, tile), 20),
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
        cuda_ms(lambda: lsd_gather.apply_merge_dense_cuda(lab, T), 20),
        cuda_ms(lambda: lsd_gather.apply_merge_dense_plain(lab, T), 20),
        0, nbytes(lab, dense) + 4 * n_active))
    rows.append(kernel_row(
        "K6 gather_labels", "lsd_gather.cu",
        "line3dpp_tpu/ops/lsd_gather.py:266", 0.0,
        cuda_ms(lambda: lsd_gather.gather_labels_cuda(flat, idx), 20),
        cuda_ms(lambda: lsd_gather.gather_labels_plain(flat, idx), 20),
        0, nbytes(idx, got6) + 4 * idx.numel(),
        library_ms=cuda_ms(lambda: torch.index_select(flat, 0, idx), 20)))

    pl = lsd._pixel_list(angle, active, idx, mag_c, ang_c, tol, tile)
    n, C = pl["n"], pl["C"]
    slot, xs, ys = pl["slot"], pl["xs"], pl["ys"]
    mag, ang = pl["mag_s"], pl["ang_s"]
    n_real = int((slot < C).sum())
    pix = torch.ones(n, dtype=torch.float32, device=dev)
    print(f"[{what}] round-1 pixel list: {n} pixels, {C} components (runs "
          f">= 5), {n_real} pixels in them", flush=True)

    # K7: float64 sums in both versions; they may differ in the last bit of
    # the float32 result only
    def rel_err(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    mom = lsd_fit.moments_cuda(slot, xs, ys, mag, pix, C)
    mom_p = lsd_fit.moments_plain(slot, xs, ys, mag, pix, C)
    torch.cuda.synchronize()
    err7 = rel_err(mom, mom_p)
    print(f"[{what}] K7 moments: max rel err {err7:.3g} (limit 1e-6), max "
          f"|err| {float((mom - mom_p).abs().max()):.3g}", flush=True)
    check(err7 <= 1e-6, "K7 disagrees with its plain version")
    terms = lsd_fit._moment_terms(xs, ys, mag, pix)
    acc7 = torch.zeros((C + 1, 7), dtype=torch.float32, device=dev)
    slot_l = slot.long()
    rows.append(kernel_row(
        "K7 moments", "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:137",
        float((mom - mom_p).abs().max()),
        cuda_ms(lambda: lsd_fit.moments_cuda(slot, xs, ys, mag, pix, C), 20),
        cuda_ms(lambda: lsd_fit.moments_plain(slot, xs, ys, mag, pix, C), 5),
        K7_OPS_PER_PIXEL * n_real, nbytes(slot, xs, ys, mag, pix, mom),
        library_ms=cuda_ms(lambda: acc7.index_add_(0, slot_l, terms), 20)))

    # the first fit's tables, and K11 on them: exact minima
    tables, npix = lsd._axis_tables(mom_p)
    ext = lsd_fit.extents_cuda(slot, xs, ys, pix, tables, C)
    ext_p = lsd_fit.extents_plain(slot, xs, ys, pix, tables, C)
    torch.cuda.synchronize()
    exact = torch.equal(ext, ext_p)
    print(f"[{what}] K11 extents: bit-exact {exact}", flush=True)
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
        cuda_ms(lambda: lsd_fit.extents_cuda(slot, xs, ys, pix, tables, C),
                20),
        cuda_ms(lambda: lsd_fit.extents_plain(slot, xs, ys, pix, tables, C),
                5),
        K11_OPS_PER_PIXEL * n_real, nbytes(slot, xs, ys, pix, tables, ext),
        library_ms=cuda_ms(
            lambda: acc11.scatter_reduce_(0, idx4, vals, "amin"), 20)))

    # the first refine step's gate, as _lsd_round builds it: K8 against its
    # plain version and its newpix against K9's on the same inputs
    f = lsd._rectangles(tables, npix, ext_p)
    t8 = lsd._refine_tables(f)
    args8 = (slot, xs, ys, ang, mag, pix, t8, True, lsd.COS_GATE, C)
    np8, mom8 = lsd_fit.gate_moments_cuda(*args8)
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
    err8 = rel_err(mom8[clean[:C]], mom8_p[clean[:C]])
    print(f"[{what}] K8 gate_moments: {int(np8.sum())} of {n} pixels kept, "
          f"{int(flip8.sum())} differ from the plain gate (limit "
          f"{1e-5 * n:.1f}), newpix equals K9's: "
          f"{torch.equal(np8, np8_k9)}, max rel err of the sums {err8:.3g} "
          f"(limit 1e-6)", flush=True)
    check(int(flip8.sum()) <= 1e-5 * n and torch.equal(np8, np8_k9)
          and err8 <= 1e-6, "K8 disagrees with its plain version")
    rows.append(kernel_row(
        "K8 gate_moments", "lsd_fit.cu", "line3dpp_tpu/ops/lsd_fit.py:368",
        float((mom8 - mom8_p)[clean[:C]].abs().max()),
        cuda_ms(lambda: lsd_fit.gate_moments_cuda(*args8), 20),
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
        cuda_ms(lambda: lsd_fit.gate_pixels_cuda(*args9), 20),
        cuda_ms(lambda: lsd_fit.gate_pixels_plain(*args9), 5),
        K9_OPS_PER_PIXEL * n_real, nbytes(slot, xs, ys, ang, pix, t9, np9)))
    return rows


def images_to_lines(images, cams, gt, ref, dev):
    """Detections against the reference's, then the images -> lines path
    through the user entry points with the launch counters read around
    it.  Returns the launches and the phase times."""
    import torch
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import kernels, lsd
    from line3dpp_tpu_torch.utils import golden

    t0 = time.perf_counter()
    runs = []
    for image in images:
        img, _ = lsd._prepare(image, -1, dev)
        segs_i, ok, st = lsd._lsd_core(img)
        runs.append((segs_i[ok].cpu().numpy().astype(np.float64), st))
    detect_s = time.perf_counter() - t0
    ref_segs = np.split(ref["segments"], np.cumsum(ref["seg_counts"])[:-1])
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
              f"{len(b)} of JAX, mutual 1-px endpoint coverage {cov:.4f}",
              flush=True)
        check(abs(len(a) - len(b)) <= DETECT_COUNT_REL * len(b)
              and cov >= DETECT_VIEW_COVERAGE,
              f"view {i}: detections differ from the JAX reference's")
    print(f"detection of {len(images)} views: {detect_s:.3f} s; mutual "
          f"coverage over all views {covered / total:.4f}", flush=True)
    check(covered / total >= DETECT_ALL_COVERAGE,
          "the detections differ from the JAX reference's")

    cfg = lt.Config(optimize=False, num_neighbors=int(ref["neighbors"]))
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
    check(abs(len(pred) - len(ref_lines)) <= 2 and f1 >= 0.99
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
        check(n > 0, f"kernel {name} was not launched on the images -> "
              f"lines path")
    check(n_rows == len(lines), "TXT rows != line count")
    check(all(np.isfinite(l.segments3d).all() for l in lines),
          "non-finite 3D segments")

    # From the port's own detections the GT metrics move as far as the
    # detections move with the order of the moment sums: GT_SPREAD above.
    got = gt_metrics([l.segments3d for l in lines])
    print(f"result: {len(lines)} lines (JAX {len(ref_lines)}) vs "
          f"{len(gt)} GT lines: {json.dumps(got)}; JAX on the CPU: "
          f"{json.dumps(want)}", flush=True)
    for k in got:
        check(got[k] >= want[k] - GT_SPREAD, f"{k} {got[k]:.4f} is more "
              f"than {GT_SPREAD} below the JAX package's {want[k]:.4f}")
    return launches, dict(phases, detect_s=detect_s)


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

    # ---- images -> lines on the full-size facade
    if not os.path.exists(SCENE2_NPZ):
        fail(f"missing {SCENE2_NPZ} (tests/make_torch_lsd_reference.py)")
    with np.load(SCENE2_NPZ) as data:
        ref = {k: data[k] for k in data.files}
    images, cams, gt, render_s = render_scene(ref)
    from line3dpp_tpu_torch.ops import lsd

    img, _ = lsd._prepare(images[0], -1, dev)
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    rows += check_lsd_kernels(*lsd._grad_compact(img), (th, tw), dev,
                              "facade view 0")
    # the same at a real photo's density, where the work is not launches
    full = {}
    for frac in FULL_SIZE_ACTIVE:
        full[f"active {frac}"] = [
            {k: r[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}
            for r in check_lsd_kernels(*synthetic_round1(frac, 0, dev), dev,
                                       f"synthetic, {frac} active")]
    torch.cuda.synchronize()
    launches, phases = images_to_lines(images, cams, gt, ref, dev)
    phases["render_s"] = render_s
    print("images -> lines phases: " + json.dumps(phases), flush=True)
    if opts.profile:
        from line3dpp_tpu_torch.ops import lsd

        profile(lambda: lsd.detect_batch(images[:1], device=dev),
                "detect_view0", opts.out)

    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "build.log"), "w") as f:
            f.write(build_log)
    for r in rows:
        r["launches"] = launches[r["name"].split()[1]]
    print(json.dumps({"full_size": full}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def profile(fn, label: str, out_dir) -> None:
    """Device time by kernel over one more run of ``fn``, and the share of
    the profiled span in which the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out_dir or tmp, f"{label}_trace.json")
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
    # the span covers the torch ops; the wall time adds host work outside
    # them (for match_images: neighbour choice, fundamental matrices)
    print(f"profile: {label} wall {1e3 * wall:.3f} ms, torch-op span "
          f"{span / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / span:.1f}% of the span, "
          f"{busy / 1e4 / wall:.1f}% of the wall), {len(device)} device "
          f"events", flush=True)


if __name__ == "__main__":
    main()
