"""Match scoring — 3D hypothesis verification.

Every match of a segment is unprojected into a 3D segment hypothesis and
compared against every other match of the same segment coming from a
*different* target camera.  The per-camera maximum of
``min(sim_angle, sim_position)`` is summed into score3D, a soft count of how
many cameras confirm the hypothesis (reference: scoringCPU line3D.cc:1208-1294,
similarityForScoring line3D.cc:1417-1446, K_score_matches
cudawrapper.cu:256-367).  Also applies the orientation filter
(checkMatchOrientation, line3D.cc:811-858) as a mask.

Matches live in a dense [V, S, M] table whose M axis is grouped by neighbour
slot: slot m belongs to neighbour group ``m // k``, and a group shares one
target camera.  :func:`score_matches` launches kernel K2
(``csrc/scoring.cu``) for CUDA tensors and runs :func:`score_matches_plain`
for CPU tensors; both follow ``line3dpp_tpu.ops.scoring`` (the XLA path,
with ``arccos``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from .geometry import DEG

EPS = 1e-12
PI_1_32 = 0.098174771    # reference: commons.h:99
PI_31_32 = 3.043417886   # reference: commons.h:100


class ScoredMatches(NamedTuple):
    score3d: torch.Tensor   # (V, S, M) f32
    valid: torch.Tensor     # (V, S, M) bool (post orientation filter)


def _score_chunk(r1, r2, rmid, d1, d2, mvalid, Cv, kv, tC, tk, *, knn: int,
                 two_sig_a_sqr: float, min_similarity: float,
                 check_orientation: bool):
    """B segments: rays (B, 3), depths/validity (B, M), own camera Cv (B, 3)
    and kv (B,), target cameras per group tC (B, N, 3) and tk (B, N)."""
    B, M = d1.shape
    N = tC.shape[1]

    # hypothesis endpoints (view.cc:356-371): P = C + ray * depth
    P1 = [Cv[:, i, None] + r1[:, i, None] * d1 for i in range(3)]  # 3x (B, M)
    P2 = [Cv[:, i, None] + r2[:, i, None] * d2 for i in range(3)]
    dv = [b - a for a, b in zip(P1, P2)]
    length = torch.sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
    inv_len = 1.0 / length.clamp_min(EPS)
    dirc = [c * inv_len for c in dv]
    ok = mvalid & (length > EPS)

    if check_orientation:
        dot = (rmid[:, 0, None] * dirc[0] + rmid[:, 1, None] * dirc[1]
               + rmid[:, 2, None] * dirc[2]).clamp(-1.0, 1.0)
        ang = torch.acos(dot)
        ok = ok & (ang > PI_1_32) & (ang < PI_31_32)

    # regularizers of the scored match (line3D.cc:1235-1248)
    tCm = tC.repeat_interleave(knn, dim=1)                         # (B, M, 3)
    tkm = tk.repeat_interleave(knn, dim=1)                         # (B, M)

    def dist_t(P):
        w = [P[i] - tCm[..., i] for i in range(3)]
        return torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])

    sig1 = d1 * kv[:, None]
    sig2 = d2 * kv[:, None]
    sig1t = dist_t(P1) * tkm
    sig2t = dist_t(P2) * tkm
    den1 = (sig1 * sig1 + sig1t * sig1t).clamp_min(EPS)[:, :, None]
    den2 = (sig2 * sig2 + sig2t * sig2t).clamp_min(EPS)[:, :, None]

    # pairwise similarity of matches (m, j), one target group of j at a
    # time; regs come from m, depth diffs vs j (line3D.cc:1417-1446).  Per
    # group max, summed over the other groups in ascending group order.
    own_group = torch.arange(M, device=d1.device) // knn
    score = torch.zeros_like(d1)
    zero = torch.zeros((), dtype=d1.dtype, device=d1.device)
    # a tensor divisor: torch turns division by a Python scalar into a
    # multiplication by its reciprocal on CUDA, which rounds differently
    # from the kernel's true division
    tsa = torch.tensor(two_sig_a_sqr, dtype=d1.dtype, device=d1.device)
    for g in range(N):
        lo, hi = g * knn, (g + 1) * knn
        dot = (dirc[0][:, :, None] * dirc[0][:, None, lo:hi]
               + dirc[1][:, :, None] * dirc[1][:, None, lo:hi]
               + dirc[2][:, :, None] * dirc[2][:, None, lo:hi]).clamp(-1.0, 1.0)
        ang = torch.acos(dot) * DEG
        ang = torch.where(ang > 90.0, 180.0 - ang, ang)
        sim_a = torch.exp(-ang * ang / tsa)
        dd1 = d1[:, :, None] - d1[:, None, lo:hi]
        dd2 = d2[:, :, None] - d2[:, None, lo:hi]
        sim_p = torch.minimum(torch.exp(-dd1 * dd1 / den1),
                              torch.exp(-dd2 * dd2 / den2))
        sim = torch.minimum(sim_a, sim_p)
        sim = torch.where((sim > min_similarity) & ok[:, :, None]
                          & ok[:, None, lo:hi], sim, zero)
        maxg = sim.amax(dim=-1)
        score = score + torch.where(own_group == g, zero, maxg)
    return torch.where(ok, score, zero), ok


def score_matches_plain(r1, r2, rmid, C, k_reg, tgt_C, tgt_k, d_p1, d_p2,
                        valid, *, knn: int, two_sig_a_sqr: float,
                        min_similarity: float = 0.5,
                        check_orientation: bool = True,
                        chunk: int = 1024) -> ScoredMatches:
    """Plain PyTorch scoring, ``chunk`` segments at a time."""
    V, S, M = d_p1.shape
    VS = V * S
    flat = lambda x: x.reshape(VS, *x.shape[2:])
    view_of = torch.arange(V, device=d_p1.device).repeat_interleave(S)
    score = torch.empty_like(d_p1).reshape(VS, M)
    ok = torch.empty_like(valid).reshape(VS, M)
    args = (flat(r1), flat(r2), flat(rmid), flat(d_p1), flat(d_p2),
            flat(valid))
    for lo in range(0, VS, chunk):
        sl = slice(lo, min(lo + chunk, VS))
        vv = view_of[sl]
        score[sl], ok[sl] = _score_chunk(
            *(a[sl] for a in args), C[vv], k_reg[vv], tgt_C[vv], tgt_k[vv],
            knn=knn, two_sig_a_sqr=two_sig_a_sqr,
            min_similarity=min_similarity,
            check_orientation=check_orientation)
    return ScoredMatches(score.reshape(V, S, M), ok.reshape(V, S, M))


def score_matches_cuda(r1, r2, rmid, C, k_reg, tgt_C, tgt_k, d_p1, d_p2,
                       valid, *, knn: int, two_sig_a_sqr: float,
                       min_similarity: float = 0.5,
                       check_orientation: bool = True) -> ScoredMatches:
    """Kernel K2 on CUDA tensors."""
    dev = d_p1.device
    V, S, M = d_p1.shape
    N = tgt_C.shape[1]
    if M > 1024 or M != N * knn:
        raise ValueError(f"kernel K2 takes M = N*knn <= 1024, got M={M}, "
                         f"N={N}, knn={knn}")
    f32 = torch.float32
    for name, x, dtype, shape in (
            ("d_p1", d_p1, f32, (V, S, M)), ("d_p2", d_p2, f32, (V, S, M)),
            ("valid", valid, torch.bool, (V, S, M)),
            ("r1", r1, f32, (V, S, 3)), ("r2", r2, f32, (V, S, 3)),
            ("rmid", rmid, f32, (V, S, 3)), ("C", C, f32, (V, 3)),
            ("k_reg", k_reg, f32, (V,)), ("tgt_C", tgt_C, f32, (V, N, 3)),
            ("tgt_k", tgt_k, f32, (V, N))):
        kernels.check(name, x, dtype, shape, dev)
    score = torch.empty((V, S, M), dtype=f32, device=dev)
    ok = torch.empty((V, S, M), dtype=torch.bool, device=dev)
    p = kernels.ptr
    kernels.launch(
        "l3d_score_matches", p(d_p1), p(d_p2), p(valid), p(r1), p(r2),
        p(rmid), p(C), p(k_reg), p(tgt_C), p(tgt_k), V, S, M, N, knn,
        float(two_sig_a_sqr), float(min_similarity), int(check_orientation),
        p(score), p(ok), kernels.stream(dev))
    kernels.LAUNCHES["score_matches"] += 1
    return ScoredMatches(score, ok)


def score_matches(r1, r2, rmid, C, k_reg, neighbor_ids, d_p1, d_p2, valid,
                  knn: int, two_sig_a_sqr: float,
                  min_similarity: float = 0.5,
                  check_orientation: bool = True,
                  chunk: int = 1024) -> ScoredMatches:
    """Score the (V, S, M) match table; M = N * knn is neighbour-grouped.

    r1, r2, rmid (V, S, 3) rays, C (V, 3), k_reg (V,), neighbor_ids (V, N).
    CUDA tensors go through kernel K2, CPU tensors through the plain
    version."""
    V, S, M = d_p1.shape
    N = neighbor_ids.shape[1]
    if M != N * knn:
        raise ValueError("match slots must be neighbor-grouped: M == N*k")
    nbr = neighbor_ids.long()
    tgt_C = C[nbr].contiguous()                       # (V, N, 3)
    tgt_k = k_reg[nbr].contiguous()                   # (V, N)
    kw = dict(knn=knn, two_sig_a_sqr=two_sig_a_sqr,
              min_similarity=min_similarity,
              check_orientation=check_orientation)
    if d_p1.is_cuda:
        return score_matches_cuda(r1, r2, rmid, C, k_reg, tgt_C, tgt_k,
                                  d_p1, d_p2, valid, **kw)
    return score_matches_plain(r1, r2, rmid, C, k_reg, tgt_C, tgt_k,
                               d_p1, d_p2, valid, chunk=chunk, **kw)
