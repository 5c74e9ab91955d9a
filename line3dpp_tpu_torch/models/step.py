"""Fused device-side forward step of the line-MVS model.

One function runs the full device compute of the pipeline — epipolar
matching (kernel K1), 3D hypothesis scoring (kernel K2), match filtering,
per-view median depths and affinity weighting (kernel K3 gathers the target
estimates) — over a batch of views (reference phases 2+3 device work:
matchImages line3D.cc:375-497 and computingAffinityMatrix
line3D.cc:1852-1979).  The counterpart of ``line3dpp_tpu.models.step``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import affinity as affinity_ops
from ..ops import geometry as geo
from ..ops import matching as matching_ops
from ..ops import scoring as scoring_ops

EPS = 1e-12


class StepOutputs(NamedTuple):
    """Per-view dense outputs of the fused forward step."""

    tgt_seg: torch.Tensor      # (V, S, M) int32 match target segment
    match_valid: torch.Tensor  # (V, S, M) bool
    score3d: torch.Tensor      # (V, S, M) f32
    kept: torch.Tensor         # (V, S, M) bool — post 10%-of-max filter
    est_valid: torch.Tensor    # (V, S) bool
    est_P1: torch.Tensor       # (V, S, 3) best-hypothesis endpoints
    est_P2: torch.Tensor       # (V, S, 3)
    est_d1: torch.Tensor       # (V, S)
    est_d2: torch.Tensor       # (V, S)
    aff_weight: torch.Tensor   # (V, S, M) f32 affinity edge weight
    aff_valid: torch.Tensor    # (V, S, M) bool
    median_depth: torch.Tensor  # (V,) f32 median kept best-match depth


def _median_positive(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Upper median over the valid entries of each row of x (B, n)
    (line3D.cc:1657-1668); EPS for a row with none."""
    n = x.shape[-1]
    srt = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))),
                     dim=-1).values
    cnt = valid.sum(-1)
    med = srt.gather(-1, (cnt // 2).clamp(0, n - 1)[..., None])[..., 0]
    return torch.where(cnt > 0, med, torch.full_like(med, EPS))


def regroup(x: torch.Tensor, V: int, N: int) -> torch.Tensor:
    """(V*N, S, k) pair-major matcher output -> (V, S, N*k) with the match
    axis grouped by neighbour slot."""
    _, S, k = x.shape
    return x.reshape(V, N, S, k).permute(0, 2, 1, 3).reshape(V, S, N * k)


def forward_step(
    segments: torch.Tensor,      # (V, S, 4) f32 2D segments (dense, masked)
    seg_mask: torch.Tensor,      # (V, S) bool
    RtKinv: torch.Tensor,        # (V, 3, 3) f32
    C: torch.Tensor,             # (V, 3) f32 (median-centered)
    k_reg: torch.Tensor,         # (V,) f32 spatial regularizer
    neighbor_ids: torch.Tensor,  # (V, N) int32
    F: torch.Tensor,             # (V, N, 3, 3) f32 fundamental matrices
    pair_valid: torch.Tensor,    # (V, N) bool
    *,
    epipolar_overlap: float = 0.25,
    knn: int = 10,
    two_sig_a_sqr: float = 200.0,
    min_similarity: float = 0.5,
    check_orientation: bool = True,
    min_best_score: float = 0.75,
    min_best_score_perc: float = 0.10,
    min_affinity: float = 0.5,
    pair_chunk: int = 8,
) -> StepOutputs:
    V, N = neighbor_ids.shape
    src_idx = torch.arange(V, dtype=torch.int32,
                           device=segments.device).repeat_interleave(N)
    pm = matching_ops.match_pairs(
        segments, seg_mask, RtKinv, C, src_idx, neighbor_ids.reshape(-1),
        F.reshape(-1, 3, 3), pair_valid.reshape(-1), epipolar_overlap, knn,
        chunk=pair_chunk)
    t_seg = regroup(pm.tgt_seg, V, N)
    t_valid = regroup(pm.valid, V, N)
    d_p1 = regroup(pm.d_p1, V, N)
    d_p2 = regroup(pm.d_p2, V, N)

    r1, r2 = geo.segment_rays(RtKinv[:, None], segments)
    mid = 0.5 * (segments[..., 0:2] + segments[..., 2:4])
    rmid = geo.rays_from_pixels(RtKinv[:, None], mid)

    scored = scoring_ops.score_matches(
        r1, r2, rmid, C, k_reg, neighbor_ids, d_p1, d_p2, t_valid,
        knn=knn, two_sig_a_sqr=two_sig_a_sqr, min_similarity=min_similarity,
        check_orientation=check_orientation)

    fm = affinity_ops.filter_matches(
        r1, r2, C, scored.score3d, scored.valid, d_p1, d_p2,
        min_best_score, min_best_score_perc)

    both = torch.cat([fm.est_d1, fm.est_d2], dim=1)
    bvalid = torch.cat([fm.est_valid, fm.est_valid], dim=1)
    median_depth = _median_positive(both, bvalid)

    # median scene depth over views for the affinity depth cutoff
    # (line3D.cc:1758-1774)
    med_scene = _median_positive(median_depth[None], median_depth[None] > EPS)[0]

    aff = affinity_ops.affinity_dense(
        fm, t_seg, neighbor_ids, k_reg, median_depth, med_scene,
        two_sig_a_sqr, min_affinity)

    return StepOutputs(
        tgt_seg=t_seg, match_valid=t_valid, score3d=scored.score3d,
        kept=fm.kept, est_valid=fm.est_valid, est_P1=fm.est_P1,
        est_P2=fm.est_P2, est_d1=fm.est_d1, est_d2=fm.est_d2,
        aff_weight=aff.weight, aff_valid=aff.edge_valid,
        median_depth=median_depth)
