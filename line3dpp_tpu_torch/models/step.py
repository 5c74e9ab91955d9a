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

from .. import obs
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


def hypothesis_rays(segments: torch.Tensor, RtKinv: torch.Tensor):
    """World rays (V, S, 3) through each segment's endpoints and midpoint."""
    r1, r2 = geo.segment_rays(RtKinv[:, None], segments)
    mid = 0.5 * (segments[..., 0:2] + segments[..., 2:4])
    return r1, r2, geo.rays_from_pixels(RtKinv[:, None], mid)


def score_inputs(segments, RtKinv, C, k_reg, neighbor_ids, pm) -> tuple:
    """Kernel K2's positional arguments (``scoring.score_matches_cuda`` and
    ``score_matches_plain``) as :func:`forward_step` gives them: the rays,
    the cameras and their targets, and K1's match table ``pm`` regrouped
    by neighbour, each contiguous."""
    V, N = neighbor_ids.shape
    nbr = neighbor_ids.long()
    return (*(r.contiguous() for r in hypothesis_rays(segments, RtKinv)),
            C, k_reg, C[nbr].contiguous(), k_reg[nbr].contiguous(),
            *(regroup(x, V, N).contiguous()
              for x in (pm.d_p1, pm.d_p2, pm.valid)))


def _match_score_filter(segments, seg_mask, RtKinv, C, k_reg, neighbor_ids,
                        F, pair_valid, *, epipolar_overlap, knn,
                        two_sig_a_sqr, min_similarity, check_orientation,
                        min_best_score, min_best_score_perc, pair_chunk,
                        src_rows=None) -> dict:
    """Matching (K1) -> scoring (K2) -> filtering -> per-view medians for a
    batch of source views.

    ``segments``/``seg_mask`` and the camera tables ``RtKinv``, ``C`` and
    ``k_reg`` cover ALL views; ``neighbor_ids``/``F``/``pair_valid`` cover
    only the batch, whose global view indices are ``src_rows`` (every view
    by default).  The targets may lie outside the batch: the blocked
    large-scene path and the view-sharded step slice the view axis this
    way, and only O(batch * S * M) memory is live."""
    V_all = seg_mask.shape[0]
    Vb, N = neighbor_ids.shape
    dev = segments.device
    if src_rows is None:
        src_rows = torch.arange(V_all, dtype=torch.int32, device=dev)
    src_rows = src_rows.to(device=dev, dtype=torch.int32)
    src_idx = src_rows.repeat_interleave(N)
    with obs.span("step.match"):
        pm = matching_ops.match_pairs(
            segments, seg_mask, RtKinv, C, src_idx, neighbor_ids.reshape(-1),
            F.reshape(-1, 3, 3), pair_valid.reshape(-1), epipolar_overlap,
            knn, chunk=pair_chunk)
        t_seg = regroup(pm.tgt_seg, Vb, N)
        t_valid = regroup(pm.valid, Vb, N)
        d_p1 = regroup(pm.d_p1, Vb, N)
        d_p2 = regroup(pm.d_p2, Vb, N)
        del pm

    with obs.span("step.score"):
        rows = src_rows.long()
        C_src, k_src = C[rows], k_reg[rows]
        r1, r2, rmid = hypothesis_rays(segments[rows], RtKinv[rows])
        scored = scoring_ops.score_matches(
            r1, r2, rmid, C_src, k_src, neighbor_ids, d_p1, d_p2, t_valid,
            knn=knn, two_sig_a_sqr=two_sig_a_sqr,
            min_similarity=min_similarity,
            check_orientation=check_orientation, C_table=C, k_table=k_reg)

    with obs.span("step.filter"):
        fm = affinity_ops.filter_matches(
            r1, r2, C_src, scored.score3d, scored.valid, d_p1, d_p2,
            min_best_score, min_best_score_perc)
        both = torch.cat([fm.est_d1, fm.est_d2], dim=1)
        bvalid = torch.cat([fm.est_valid, fm.est_valid], dim=1)
        median_depth = _median_positive(both, bvalid)
    return dict(t_seg=t_seg, t_valid=t_valid, d_p1=d_p1, d_p2=d_p2,
                scored=scored, fm=fm, median_depth=median_depth, r1=r1,
                r2=r2)


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
    med_scene_depth_static: float = -1.0,
    pair_chunk: int = 8,
    use_pallas_matching: bool = False,
    use_pallas_scoring: bool = False,
    pallas_interpret: bool = False,
) -> StepOutputs:
    """The JAX package's ``forward_step`` with its parameters.
    ``med_scene_depth_static > 0`` replaces the median scene depth of the
    affinity cutoff.  The three Pallas switches are accepted and ignored:
    the kernels run exactly when the tensors are on a CUDA device."""
    msf = _match_score_filter(
        segments, seg_mask, RtKinv, C, k_reg, neighbor_ids, F, pair_valid,
        epipolar_overlap=epipolar_overlap, knn=knn,
        two_sig_a_sqr=two_sig_a_sqr, min_similarity=min_similarity,
        check_orientation=check_orientation, min_best_score=min_best_score,
        min_best_score_perc=min_best_score_perc, pair_chunk=pair_chunk)
    t_seg, fm = msf["t_seg"], msf["fm"]
    median_depth = msf["median_depth"]

    with obs.span("step.affinity"):
        # median scene depth over views for the affinity depth cutoff
        # (line3D.cc:1758-1774), unless the caller fixes it
        if med_scene_depth_static > 0:
            med_scene = float(med_scene_depth_static)
        else:
            med_scene = _median_positive(median_depth[None],
                                         median_depth[None] > EPS)[0]
        aff = affinity_ops.affinity_dense(
            fm, t_seg, neighbor_ids, k_reg, median_depth, med_scene,
            two_sig_a_sqr, min_affinity)

    return step_outputs(msf, aff)


def step_outputs(msf: dict, aff) -> StepOutputs:
    """The step's outputs from :func:`_match_score_filter`'s and the
    affinity stage's."""
    fm = msf["fm"]
    return StepOutputs(
        tgt_seg=msf["t_seg"], match_valid=msf["t_valid"],
        score3d=msf["scored"].score3d, kept=fm.kept,
        est_valid=fm.est_valid, est_P1=fm.est_P1, est_P2=fm.est_P2,
        est_d1=fm.est_d1, est_d2=fm.est_d2, aff_weight=aff.weight,
        aff_valid=aff.edge_valid, median_depth=msf["median_depth"])
