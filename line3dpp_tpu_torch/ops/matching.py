"""Pairwise epipolar line matching (reference: matchingCPU line3D.cc:900-1015,
K_match_lines cudawrapper.cu:186-253, kNN selection cudawrapper.cu:592-650).

For a view pair (src, tgt) and every segment pair (s, c): the parameters
``t = -(e . q1h) / (e . dqh)`` where the epipolar lines ``e`` of the source
endpoints cut the target segment ``q(t) = q1 + t (q2 - q1)``, the mutual
overlap of the four collinear points {t1, t2, 0, 1} (line3D.cc:1086-1165),
the signs of the four plane-ray triangulation depths ``n.(C' - C)/(n.ray)``
(line3D.cc:1168-1193), and the k best valid matches of every source
segment by overlap, ties to the lowest target index.  Only the winners'
depths are computed.

:func:`match_pairs` launches kernel K1 (``csrc/matching.cu``) for CUDA
tensors and runs :func:`match_pairs_plain` for CPU tensors.  Both read the
same per-view and per-pair tables (:func:`pair_tables`) and evaluate the
same float32 expressions in the same order.  Everything is float32; the
scene must be median-centered by the caller (line3D.cc:500-536).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from . import kernels

EPS = 1e-12
KNN_MAX = 16          # largest k kernel K1 takes (csrc/matching.cu KMAX)


class PairMatches(NamedTuple):
    """k best matches per (pair, src segment), each (P, S, k).  Invalid
    slots hold target index 0 and zeros."""

    tgt_seg: torch.Tensor   # int32 target segment index
    overlap: torch.Tensor   # f32 epipolar overlap score
    d_p1: torch.Tensor      # f32 src endpoint-1 depth
    d_p2: torch.Tensor      # f32 src endpoint-2 depth
    d_q1: torch.Tensor      # f32 tgt endpoint-1 depth
    d_q2: torch.Tensor      # f32 tgt endpoint-2 depth
    valid: torch.Tensor     # bool


class PairTables(NamedTuple):
    """Inputs of the matcher, shared by the kernel and the plain version."""

    segments: torch.Tensor    # (V, S, 4) f32
    mask: torch.Tensor        # (V, S) bool
    r1: torch.Tensor          # (V, S, 3) endpoint-1 rays
    r2: torch.Tensor          # (V, S, 3) endpoint-2 rays
    n: torch.Tensor           # (V, S, 3) segment plane normals
    seglen: torch.Tensor      # (V, S) 2D segment lengths
    e1: torch.Tensor          # (P, S, 3) epipolar lines F p1h of src segments
    e2: torch.Tensor          # (P, S, 3) F p2h
    num_src: torch.Tensor     # (P, S) n_tgt . (C_tgt - C_src) per tgt segment
    num_tgt: torch.Tensor     # (P, S) n_src . (C_src - C_tgt) per src segment
    src_idx: torch.Tensor     # (P,) int32
    tgt_idx: torch.Tensor     # (P,) int32
    pair_valid: torch.Tensor  # (P,) bool


def pair_tables(segments, seg_mask, RtKinv, C, src_idx, tgt_idx, F,
                pair_valid) -> PairTables:
    """Per-view rays, plane normals and lengths, per-pair epipolar lines and
    depth numerators (line3D.cc:925-926, 1182-1185)."""
    r1, r2 = geo.segment_rays(RtKinv[:, None], segments)
    n = geo.normalize(geo.cross(r1, r2))
    d = segments[..., 2:4] - segments[..., 0:2]
    seglen = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])

    src, tgt = src_idx.long(), tgt_idx.long()
    xs = segments[src]                                   # (P, S, 4)
    Fp = F[:, None]                                      # (P, 1, 3, 3)

    def epi(x, y):                                       # F @ (x, y, 1)
        return Fp[..., 0] * x[..., None] + Fp[..., 1] * y[..., None] \
            + Fp[..., 2]

    e1 = epi(xs[..., 0], xs[..., 1])
    e2 = epi(xs[..., 2], xs[..., 3])
    num_src = geo.dot3(n[tgt], (C[tgt] - C[src])[:, None, :])
    num_tgt = geo.dot3(n[src], (C[src] - C[tgt])[:, None, :])
    return PairTables(
        segments=segments.contiguous(), mask=seg_mask.contiguous(),
        r1=r1.contiguous(), r2=r2.contiguous(), n=n.contiguous(),
        seglen=seglen.contiguous(), e1=e1.contiguous(), e2=e2.contiguous(),
        num_src=num_src.contiguous(), num_tgt=num_tgt.contiguous(),
        src_idx=src_idx.to(torch.int32).contiguous(),
        tgt_idx=tgt_idx.to(torch.int32).contiguous(),
        pair_valid=pair_valid.contiguous())


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > EPS, x, torch.full_like(x, EPS))


def _positive_depth(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return (den.abs() > EPS) & (num * den > 0)


def _match_chunk(t: PairTables, lo: int, hi: int, epipolar_overlap: float,
                 knn: int) -> PairMatches:
    src, tgt = t.src_idx[lo:hi].long(), t.tgt_idx[lo:hi].long()
    tseg = t.segments[tgt]                               # (Pc, S, 4)
    q1x = tseg[:, None, :, 0]                            # (Pc, 1, S)
    q1y = tseg[:, None, :, 1]
    dqx = (tseg[..., 2] - tseg[..., 0])[:, None, :]
    dqy = (tseg[..., 3] - tseg[..., 1])[:, None, :]
    e1 = t.e1[lo:hi, :, None, :]                         # (Pc, S, 1, 3)
    e2 = t.e2[lo:hi, :, None, :]

    # intersection parameters along the target segments
    e1q1 = e1[..., 0] * q1x + e1[..., 1] * q1y + e1[..., 2]
    e1dq = e1[..., 0] * dqx + e1[..., 1] * dqy
    e2q1 = e2[..., 0] * q1x + e2[..., 1] * q1y + e2[..., 2]
    e2dq = e2[..., 0] * dqx + e2[..., 1] * dqy
    zval = (e1dq.abs() > EPS) & (e2dq.abs() > EPS)
    one = torch.ones_like(e1dq)
    t1 = -e1q1 / torch.where(zval, e1dq, one)
    t2 = -e2q1 / torch.where(zval, e2dq, one)

    # mutual overlap of {t1, t2, 0, 1} on the target line
    lo_t = torch.minimum(t1, t2)
    hi_t = torch.maximum(t1, t2)
    outer = hi_t.clamp_min(1.0) - lo_t.clamp_max(0.0)
    inner = hi_t.clamp_max(1.0) - lo_t.clamp_min(0.0)
    outer_px = outer * t.seglen[tgt][:, None, :]
    overlap = torch.where((inner >= -EPS) & (outer_px >= 1.0) & zval,
                          inner / outer.clamp_min(EPS),
                          torch.zeros_like(inner))

    # triangulation depth signs
    rp1 = t.r1[src][:, :, None, :]                       # (Pc, S, 1, 3)
    rp2 = t.r2[src][:, :, None, :]
    ns = t.n[src][:, :, None, :]
    nt = t.n[tgt][:, None, :, :]                         # (Pc, 1, S, 3)
    rq1 = t.r1[tgt][:, None, :, :]
    rq2 = t.r2[tgt][:, None, :, :]
    num_s = t.num_src[lo:hi, None, :]                    # (Pc, 1, S)
    num_t = t.num_tgt[lo:hi, :, None]                    # (Pc, S, 1)
    depths_ok = (_positive_depth(num_s, geo.dot3(rp1, nt))
                 & _positive_depth(num_s, geo.dot3(rp2, nt))
                 & _positive_depth(num_t, geo.dot3(ns, rq1))
                 & _positive_depth(num_t, geo.dot3(ns, rq2)))

    valid = ((overlap > epipolar_overlap) & depths_ok
             & (t.mask[src] & t.pair_valid[lo:hi, None])[:, :, None]
             & t.mask[tgt][:, None, :])
    masked = torch.where(valid, overlap, torch.full_like(overlap, -1.0))

    # k best by overlap; the stable sort keeps the lowest index first among
    # equal overlaps, as lax.top_k does (matching.py:170)
    top, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[..., :knn], order[..., :knn]          # (Pc, S, k)
    ok = top > 0.0

    # depths of the winners only
    rows = torch.arange(hi - lo, device=idx.device)[:, None, None]
    nt_w = t.n[tgt][rows, idx]                           # (Pc, S, k, 3)
    num_s_w = t.num_src[lo:hi][rows, idx]                # (Pc, S, k)
    zero = torch.zeros_like(top)

    def depth(num, den):
        return torch.where(ok, num / _safe(den), zero)

    return PairMatches(
        tgt_seg=torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int32),
        overlap=torch.where(ok, top, zero),
        d_p1=depth(num_s_w, geo.dot3(rp1, nt_w)),
        d_p2=depth(num_s_w, geo.dot3(rp2, nt_w)),
        d_q1=depth(num_t, geo.dot3(ns, t.r1[tgt][rows, idx])),
        d_q2=depth(num_t, geo.dot3(ns, t.r2[tgt][rows, idx])),
        valid=ok)


def match_pairs_plain(t: PairTables, epipolar_overlap: float, knn: int,
                      chunk: int = 8) -> PairMatches:
    """Plain PyTorch matcher over the pair list, ``chunk`` pairs at a time so
    the (chunk, S, S) temporaries bound memory."""
    P = t.src_idx.shape[0]
    parts = [_match_chunk(t, lo, min(lo + chunk, P), epipolar_overlap, knn)
             for lo in range(0, P, chunk)]
    return PairMatches(*(torch.cat(xs, dim=0) for xs in zip(*parts)))


def match_pairs_cuda(t: PairTables, epipolar_overlap: float,
                     knn: int) -> PairMatches:
    """Kernel K1 on CUDA tensors; outputs in (P, S, k)."""
    dev = t.segments.device
    V, S, _ = t.segments.shape
    P = t.src_idx.shape[0]
    if not 1 <= knn <= KNN_MAX:
        raise ValueError(f"kernel K1 takes 1 <= knn <= {KNN_MAX}, got {knn}")
    f32 = torch.float32
    for name, x, dtype, shape in (
            ("segments", t.segments, f32, (V, S, 4)),
            ("mask", t.mask, torch.bool, (V, S)),
            ("r1", t.r1, f32, (V, S, 3)), ("r2", t.r2, f32, (V, S, 3)),
            ("n", t.n, f32, (V, S, 3)), ("seglen", t.seglen, f32, (V, S)),
            ("e1", t.e1, f32, (P, S, 3)), ("e2", t.e2, f32, (P, S, 3)),
            ("num_src", t.num_src, f32, (P, S)),
            ("num_tgt", t.num_tgt, f32, (P, S)),
            ("src_idx", t.src_idx, torch.int32, (P,)),
            ("tgt_idx", t.tgt_idx, torch.int32, (P,)),
            ("pair_valid", t.pair_valid, torch.bool, (P,))):
        kernels.check(name, x, dtype, shape, dev)
    idx = torch.empty((P, S, knn), dtype=torch.int32, device=dev)
    ov, dp1, dp2, dq1, dq2 = (torch.empty((P, S, knn), dtype=f32, device=dev)
                              for _ in range(5))
    p = kernels.ptr
    kernels.launch(
        "l3d_match_pairs", p(t.segments), p(t.mask), p(t.r1), p(t.r2),
        p(t.n), p(t.seglen), p(t.e1), p(t.e2), p(t.num_src), p(t.num_tgt),
        p(t.src_idx), p(t.tgt_idx), p(t.pair_valid), P, S, knn,
        float(epipolar_overlap), p(idx), p(ov), p(dp1), p(dp2), p(dq1),
        p(dq2), kernels.stream(dev))
    kernels.LAUNCHES["match_pairs"] += 1
    return PairMatches(idx, ov, dp1, dp2, dq1, dq2, ov > 0.0)


def match_pairs(segments, seg_mask, RtKinv, C, src_idx, tgt_idx, F,
                pair_valid, epipolar_overlap: float, knn: int,
                chunk: int = 8) -> PairMatches:
    """Match every source segment of each (src_idx[p], tgt_idx[p]) pair.

    segments (V, S, 4), seg_mask (V, S), RtKinv (V, 3, 3), C (V, 3), the
    pair list (P,) and F (P, 3, 3) src -> tgt; pairs with ``pair_valid``
    false yield no matches.  Returns (P, S, k) tables.  CUDA tensors go
    through kernel K1, CPU tensors through the plain version."""
    t = pair_tables(segments, seg_mask, RtKinv, C, src_idx, tgt_idx, F,
                    pair_valid)
    if segments.is_cuda:
        return match_pairs_cuda(t, epipolar_overlap, knn)
    return match_pairs_plain(t, epipolar_overlap, knn, chunk)
