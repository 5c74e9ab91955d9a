"""Match filtering, best-hypothesis selection, and affinity edge computation.

Filtering (reference: filterMatches line3D.cc:1586-1669): matches must score
at least 10% of the view's best score; the best match per segment (if above
0.75) becomes that segment's *estimated 3D position*, and the median of the
kept best-match depths becomes the view's regularization depth.

Affinity (reference: computingAffinityMatrix line3D.cc:1852-1979 and
similarity line3D.cc:1449-1553): for every segment with an estimate and every
of its kept matches whose target segment also has an estimate, a symmetric
similarity of the two 3D hypotheses (angle + mutual point-to-line distances
with depth-cutoff regularizers) yields a sparse edge when > 0.5.

The target estimates are gathered by :func:`gather_target_estimates`, which
launches kernel K3 (``csrc/affinity_gather.cu``) for CUDA tensors and runs
:func:`gather_target_estimates_plain` for CPU tensors.  The similarity math
is plain torch over dense (V, S, M) tensors; :func:`compact_edges` extracts
the edges in row-major order.  The blocked large-scene path compacts each
block's kept matches (:func:`compact_kept`) and evaluates the same
similarity edge by edge (:func:`affinity_edges_flat`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from . import kernels
from .geometry import DEG

EPS = 1e-12


class FilteredMatches(NamedTuple):
    kept: torch.Tensor         # (V, S, M) bool — survives the 10%-of-max cut
    est_valid: torch.Tensor    # (V, S) bool — best score > 0.75
    est_P1: torch.Tensor       # (V, S, 3) hypothesis endpoints
    est_P2: torch.Tensor       # (V, S, 3)
    est_d1: torch.Tensor       # (V, S) best-match depth 1
    est_d2: torch.Tensor       # (V, S) best-match depth 2
    max_score: torch.Tensor    # (V,)


def filter_matches(r1, r2, C, score3d, valid, d_p1, d_p2,
                   min_best_score: float = 0.75,
                   min_best_score_perc: float = 0.10) -> FilteredMatches:
    zero = torch.zeros((), dtype=score3d.dtype, device=score3d.device)
    score = torch.where(valid, score3d, zero)
    max_score = score.amax(dim=(1, 2))                             # (V,)
    lim = (min_best_score_perc * max_score)[:, None, None]
    kept = valid & (score > 0.0) & (score > lim)

    # argmax returns the first maximal index, as jnp.argmax does
    best_slot = torch.where(kept, score, zero).argmax(dim=-1, keepdim=True)
    best_score = score.gather(-1, best_slot)[..., 0]
    est_valid = kept.any(-1) & (best_score > min_best_score)

    # segments whose best match is not good enough lose ALL their matches
    # (line3D.cc:1648-1652)
    kept = kept & est_valid[..., None]

    bd1 = d_p1.gather(-1, best_slot)[..., 0]
    bd2 = d_p2.gather(-1, best_slot)[..., 0]
    return FilteredMatches(
        kept=kept, est_valid=est_valid,
        est_P1=C[:, None, :] + r1 * bd1[..., None],
        est_P2=C[:, None, :] + r2 * bd2[..., None],
        est_d1=bd1, est_d2=bd2, max_score=max_score)


class TargetEstimates(NamedTuple):
    """Estimates of every match slot's target segment, each (V, S, M)."""

    P1: list          # 3x f32 planes
    P2: list          # 3x f32 planes
    d1: torch.Tensor
    d2: torch.Tensor
    valid: torch.Tensor   # bool


def gather_target_estimates_plain(est_P1, est_P2, est_d1, est_d2, est_valid,
                                  neighbor_ids, tgt_seg,
                                  knn: int) -> TargetEstimates:
    """Plain PyTorch gather: ``table[neighbor_ids[v, m // k], tgt_seg]``."""
    V, S, M = tgt_seg.shape
    tview = neighbor_ids.long().repeat_interleave(knn, dim=1)[:, None, :]
    tview = tview.expand(V, S, M)
    ts = tgt_seg.long()
    P1 = est_P1[tview, ts]                                       # (V, S, M, 3)
    P2 = est_P2[tview, ts]
    return TargetEstimates(
        P1=[P1[..., i] for i in range(3)], P2=[P2[..., i] for i in range(3)],
        d1=est_d1[tview, ts], d2=est_d2[tview, ts],
        valid=est_valid[tview, ts])


def estimate_table(est_P1, est_P2, est_d1, est_d2) -> torch.Tensor:
    """(V, S, 8) f32 rows [P1 xyz, P2 xyz, d1, d2], the layout K3 reads."""
    return torch.cat([est_P1, est_P2, est_d1[..., None], est_d2[..., None]],
                     dim=-1).contiguous()


def gather_target_estimates_cuda(table, est_valid, neighbor_ids, tgt_seg,
                                 knn: int) -> TargetEstimates:
    """Kernel K3 on CUDA tensors: ``table`` from :func:`estimate_table`."""
    dev = tgt_seg.device
    V_tab, S, _ = table.shape
    V, _, M = tgt_seg.shape
    N = neighbor_ids.shape[1]
    if M != N * knn:
        raise ValueError(f"kernel K3 takes M = N*knn, got M={M}, N={N}, "
                         f"knn={knn}")
    for name, x, dtype, shape in (
            ("table", table, torch.float32, (V_tab, S, 8)),
            ("est_valid", est_valid, torch.bool, (V_tab, S)),
            ("neighbor_ids", neighbor_ids, torch.int32, (V, N)),
            ("tgt_seg", tgt_seg, torch.int32, (V, S, M))):
        kernels.check(name, x, dtype, shape, dev)
    out = torch.empty((8, V, S, M), dtype=torch.float32, device=dev)
    valid = torch.empty((V, S, M), dtype=torch.bool, device=dev)
    p = kernels.ptr
    kernels.launch(
        "l3d_gather_target_estimates", p(table), p(est_valid),
        p(neighbor_ids), p(tgt_seg), V_tab, S, V, M, N, knn, p(out),
        p(valid), kernels.stream(dev))
    obs.launched("gather_target_estimates")
    return TargetEstimates(P1=[out[0], out[1], out[2]],
                           P2=[out[3], out[4], out[5]],
                           d1=out[6], d2=out[7], valid=valid)


def gather_target_estimates(est_P1, est_P2, est_d1, est_d2, est_valid,
                            neighbor_ids, tgt_seg,
                            knn: int) -> TargetEstimates:
    """For every match slot (v, s, m), the estimate of target segment
    ``tgt_seg[v, s, m]`` in view ``neighbor_ids[v, m // knn]``.  CUDA
    tensors go through kernel K3, CPU tensors through the plain version."""
    if tgt_seg.is_cuda:
        return gather_target_estimates_cuda(
            estimate_table(est_P1, est_P2, est_d1, est_d2),
            est_valid.contiguous(), neighbor_ids.to(torch.int32).contiguous(),
            tgt_seg.to(torch.int32).contiguous(), knn)
    return gather_target_estimates_plain(est_P1, est_P2, est_d1, est_d2,
                                         est_valid, neighbor_ids, tgt_seg, knn)


class AffinityDense(NamedTuple):
    weight: torch.Tensor       # (V, S, M) f32 similarity of (seg, match-target)
    edge_valid: torch.Tensor   # (V, S, M) bool


def affinity_dense(fm: FilteredMatches, tgt_seg, neighbor_ids, k_reg,
                   median_depth, med_scene_depth_lines, two_sig_a_sqr: float,
                   min_affinity: float = 0.5, tgt_est=None, k_table=None,
                   median_depth_table=None, use_pallas: bool = False,
                   pallas_interpret: bool = False) -> AffinityDense:
    """Similarity of each (segment-estimate, match-target-estimate) pair
    (reference: line3D.cc:1449-1553, called from 1873-1899).

    ``use_pallas`` and ``pallas_interpret`` are the JAX package's switches,
    accepted and ignored: kernel K3 runs exactly when the tensors are on a
    CUDA device.

    ``med_scene_depth_lines`` is a 0-dim tensor or a float; <= EPS disables
    the scene-level depth cutoff.  Where the view axis is sharded, ``fm``,
    ``tgt_seg``, ``neighbor_ids``, ``k_reg`` and ``median_depth`` are the
    local shard's, and ``tgt_est`` (its ``est_*`` fields), ``k_table`` and
    ``median_depth_table`` the gathered global tables that the target view
    indices address; they default to the local ones."""
    V, S, M = tgt_seg.shape
    N = neighbor_ids.shape[1]
    k = M // N
    dev, f32 = tgt_seg.device, torch.float32
    tgt_est = fm if tgt_est is None else tgt_est
    k_table = k_reg if k_table is None else k_table
    if median_depth_table is None:
        median_depth_table = median_depth

    tgt = gather_target_estimates(tgt_est.est_P1, tgt_est.est_P2,
                                  tgt_est.est_d1, tgt_est.est_d2,
                                  tgt_est.est_valid, neighbor_ids, tgt_seg, k)
    P1b, P2b, d1b, d2b = tgt.P1, tgt.P2, tgt.d1, tgt.d2

    # own estimates, broadcast over M
    P1a = [fm.est_P1[..., i, None] for i in range(3)]            # 3x (V, S, 1)
    P2a = [fm.est_P2[..., i, None] for i in range(3)]
    d1a, d2a = fm.est_d1[..., None], fm.est_d2[..., None]

    def direction(P1, P2):
        dv = [b - a for a, b in zip(P1, P2)]
        length = torch.sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
        den = length.clamp_min(EPS)
        return [c / den for c in dv], length

    dira, lena = direction(P1a, P2a)
    dirb, lenb = direction(P1b, P2b)
    ok = (fm.est_valid[..., None] & tgt.valid & fm.kept
          & (lena > EPS) & (lenb > EPS))

    # angular similarity (line3D.cc:1487-1489)
    dot = (dira[0] * dirb[0] + dira[1] * dirb[1]
           + dira[2] * dirb[2]).clamp(-1.0, 1.0)
    ang = torch.acos(dot) * DEG
    ang = torch.where(ang > 90.0, 180.0 - ang, ang)
    sim_a = torch.exp(-ang * ang / torch.tensor(two_sig_a_sqr, dtype=f32,
                                                device=dev))

    # depth-cutoff regularizers (line3D.cc:1491-1536):
    # sig = min(depth, cutoff) * k_view,  cutoff = min(median_depth, scene med)
    med_scene = torch.as_tensor(med_scene_depth_lines, dtype=f32, device=dev)
    scene_cut = torch.where(med_scene > EPS, med_scene,
                            torch.full_like(med_scene, float("inf")))
    cut_a = torch.minimum(median_depth[:, None, None], scene_cut)
    # per-target-view scalars: (V, N) lookup repeated over the group's slots
    nbr = neighbor_ids.long()
    per_pair = lambda t: t[nbr].repeat_interleave(k, dim=1)[:, None, :]
    cut_b = torch.minimum(per_pair(median_depth_table), scene_cut)
    k_a = k_reg[:, None, None]
    k_b = per_pair(k_table)
    sig11 = torch.minimum(d1a, cut_a) * k_a
    sig12 = torch.minimum(d2a, cut_a) * k_a
    sig21 = torch.minimum(d1b, cut_b) * k_b
    sig22 = torch.minimum(d2b, cut_b) * k_b

    # mutual point-to-line distances (line3D.cc:1501-1505):
    # d^2 = |w|^2 - (w . dir)^2 with w = P - L0
    def p2l(P, L0, Ld):
        w = [p - l0 for p, l0 in zip(P, L0)]
        w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        proj = w[0] * Ld[0] + w[1] * Ld[1] + w[2] * Ld[2]
        return torch.sqrt((w2 - proj * proj).clamp_min(0.0))

    d11 = p2l(P1a, P1b, dirb)   # dist of own P1 to target line
    d12 = p2l(P2a, P1b, dirb)
    d21 = p2l(P1b, P1a, dira)
    d22 = p2l(P2b, P1a, dira)

    def expf(d, sig):
        return torch.exp(-d * d / (2.0 * sig * sig).clamp_min(EPS))

    sim_p1 = torch.minimum(expf(d11, sig11), expf(d12, sig12))
    sim_p2 = torch.minimum(expf(d21, sig21), expf(d22, sig22))
    sim = torch.minimum(sim_a, torch.minimum(sim_p1, sim_p2))

    edge_valid = ok & (sim > min_affinity)
    return AffinityDense(
        weight=torch.where(edge_valid, sim, torch.zeros_like(sim)),
        edge_valid=edge_valid)


def compact_edges(aff: AffinityDense, tgt_seg: torch.Tensor):
    """Flat indices into (V, S, M), weights and target segments of the
    valid edges, in row-major order (the order of ``jnp.nonzero``), as host
    arrays; only O(E) values leave the device."""
    idx = torch.nonzero(aff.edge_valid.reshape(-1)).reshape(-1)
    return (idx.cpu().numpy(), aff.weight.reshape(-1)[idx].cpu().numpy(),
            tgt_seg.reshape(-1)[idx].cpu().numpy().astype(np.int64))


def compact_kept(kept: torch.Tensor, tgt_seg: torch.Tensor):
    """Flat indices into the (Vb, S, M) block of the kept matches, in
    row-major order (``jnp.nonzero``'s), and each one's target segment, as
    host arrays."""
    idx = torch.nonzero(kept.reshape(-1)).reshape(-1)
    return (idx.cpu().numpy(),
            tgt_seg.reshape(-1)[idx].cpu().numpy().astype(np.int64))


def affinity_edges_flat(est_P1, est_P2, est_d1, est_d2, est_valid, src_v,
                        src_s, tgt_v, tgt_s, edge_ok, k_reg, median_depth,
                        med_scene, two_sig_a_sqr: float,
                        min_affinity: float = 0.5):
    """Edge-wise affinity over a flat edge list: the O(E) form of
    :func:`affinity_dense` that the blocked large-scene path uses (the same
    math, line3D.cc:1449-1553), written in :func:`affinity_dense`'s
    expression order so that both give the same bits for the same edge.

    The ``est_*`` tables (V, S, ...) and ``k_reg``/``median_depth`` (V,)
    cover every view; the edges (E,) name their source and target views
    and segments.  Returns the weights (0 where invalid) and validity."""
    dev, f32 = est_d1.device, torch.float32
    sv, ss, tv, ts = (x.long() for x in (src_v, src_s, tgt_v, tgt_s))
    P1a = [est_P1[sv, ss, i] for i in range(3)]                 # 3x (E,)
    P2a = [est_P2[sv, ss, i] for i in range(3)]
    P1b = [est_P1[tv, ts, i] for i in range(3)]
    P2b = [est_P2[tv, ts, i] for i in range(3)]
    d1a, d2a = est_d1[sv, ss], est_d2[sv, ss]
    d1b, d2b = est_d1[tv, ts], est_d2[tv, ts]

    def direction(P1, P2):
        dv = [b - a for a, b in zip(P1, P2)]
        length = torch.sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
        den = length.clamp_min(EPS)
        return [c / den for c in dv], length

    dira, lena = direction(P1a, P2a)
    dirb, lenb = direction(P1b, P2b)
    ok = (edge_ok & est_valid[sv, ss] & est_valid[tv, ts]
          & (lena > EPS) & (lenb > EPS))

    dot = (dira[0] * dirb[0] + dira[1] * dirb[1]
           + dira[2] * dirb[2]).clamp(-1.0, 1.0)
    ang = torch.acos(dot) * DEG
    ang = torch.where(ang > 90.0, 180.0 - ang, ang)
    sim_a = torch.exp(-ang * ang / torch.tensor(two_sig_a_sqr, dtype=f32,
                                                device=dev))

    med_scene = torch.as_tensor(med_scene, dtype=f32, device=dev)
    scene_cut = torch.where(med_scene > EPS, med_scene,
                            torch.full_like(med_scene, float("inf")))
    cut_a = torch.minimum(median_depth[sv], scene_cut)
    cut_b = torch.minimum(median_depth[tv], scene_cut)
    k_a, k_b = k_reg[sv], k_reg[tv]
    sig11 = torch.minimum(d1a, cut_a) * k_a
    sig12 = torch.minimum(d2a, cut_a) * k_a
    sig21 = torch.minimum(d1b, cut_b) * k_b
    sig22 = torch.minimum(d2b, cut_b) * k_b

    def p2l(P, L0, Ld):
        w = [p - l0 for p, l0 in zip(P, L0)]
        w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        proj = w[0] * Ld[0] + w[1] * Ld[1] + w[2] * Ld[2]
        return torch.sqrt((w2 - proj * proj).clamp_min(0.0))

    d11 = p2l(P1a, P1b, dirb)
    d12 = p2l(P2a, P1b, dirb)
    d21 = p2l(P1b, P1a, dira)
    d22 = p2l(P2b, P1a, dira)

    def expf(d, sig):
        return torch.exp(-d * d / (2.0 * sig * sig).clamp_min(EPS))

    sim_p1 = torch.minimum(expf(d11, sig11), expf(d12, sig12))
    sim_p2 = torch.minimum(expf(d21, sig21), expf(d22, sig22))
    sim = torch.minimum(sim_a, torch.minimum(sim_p1, sim_p2))

    valid = ok & (sim > min_affinity)
    return torch.where(valid, sim, torch.zeros_like(sim)), valid


def best_kept_score(score3d: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """(V, S) each segment's best kept match score, 0 where it keeps none."""
    return torch.where(kept, score3d, torch.zeros_like(score3d)).amax(-1)


def rel_cut(aff: AffinityDense, score3d: torch.Tensor, kept: torch.Tensor,
            rel: float) -> AffinityDense:
    """``Config.match_rel_cut``: an affinity edge survives only where its
    match scores at least ``rel`` times its segment's best kept score; the
    weight of a dropped edge is zeroed (the JAX package's
    ``_rel_cut_mask``)."""
    best = best_kept_score(score3d, kept)[..., None]
    rel32 = torch.tensor(rel, dtype=torch.float32, device=score3d.device)
    mask = aff.edge_valid & (score3d >= rel32 * best)
    return AffinityDense(weight=torch.where(mask, aff.weight,
                                            torch.zeros_like(aff.weight)),
                         edge_valid=mask)
