"""Matching, scoring, filtering and affinities of one scene, in float64
torch on any device, written from Line3D++'s formulas:

- matching (matchingCPU line3D.cc:900-1015): the epipolar lines of a
  source segment's endpoints cut its neighbour's segment at parameters
  t1, t2; the overlap of {t1, t2} with {0, 1} over their union
  (line3D.cc:1086-1165) must pass ``epipolar_overlap`` and the four
  plane-ray depths must be positive (line3D.cc:1168-1193); the ``knn``
  best by overlap are kept per segment and neighbour;
- scoring (scoringCPU line3D.cc:1208-1294, similarityForScoring
  1417-1446): each match's 3D hypothesis against the matches of the same
  segment from the other neighbours, the best per neighbour summed, after
  the orientation test (checkMatchOrientation line3D.cc:811-858);
- filtering (filterMatches line3D.cc:1586-1669): 10% of the view's best
  score, the best match above ``min_best_score_3d`` as the segment's
  estimate, the upper median of the estimates' depths per view;
- affinities (computingAffinityMatrix line3D.cc:1852-1979, similarity
  1449-1553): the angle and the four point-to-line distances of the two
  estimates, with depth-capped regularisers.

Nothing here is shared with the program: the layout is the reference's
own (a matrix of candidates per view pair, a (segments, slots, slots)
block for the scores), and every value is float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-12
PI_1_32 = 0.098174771     # commons.h:99
PI_31_32 = 3.043417886    # commons.h:100
PAIR_BLOCK = 1 << 23      # elements of a (segments, slots, slots) block


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        EPS)


def rays(RtKinv: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Unit rays (..., 3) of pixels xy (..., 2) through RtKinv (..., 3, 3)
    broadcast against them."""
    h = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    return _unit((RtKinv @ h[..., None])[..., 0])


def match_pair(v, u, F, T, o):
    """The ``knn`` best matches of every segment of view v in view u:
    targets, validity and the two source depths, each (S, k)."""
    segs, mask = T["segs"], T["mask"]
    p, q = segs[v], segs[u]
    one = torch.ones_like(p[:, :1])
    e1 = torch.cat([p[:, 0:2], one], 1) @ F.T             # (S, 3) lines
    e2 = torch.cat([p[:, 2:4], one], 1) @ F.T
    q1 = torch.cat([q[:, 0:2], torch.ones_like(q[:, :1])], 1)
    dq = torch.cat([q[:, 2:4] - q[:, 0:2], torch.zeros_like(q[:, :1])], 1)
    a1, b1 = e1 @ q1.T, e1 @ dq.T                          # (S, S)
    a2, b2 = e2 @ q1.T, e2 @ dq.T
    cut = (b1.abs() > EPS) & (b2.abs() > EPS)
    t1 = -a1 / torch.where(cut, b1, torch.ones_like(b1))
    t2 = -a2 / torch.where(cut, b2, torch.ones_like(b2))
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    inner = torch.minimum(hi, torch.ones_like(hi)) - lo.clamp_min(0.0)
    union = hi.clamp_min(1.0) - torch.minimum(lo, torch.zeros_like(lo))
    qlen = torch.linalg.vector_norm(q[:, 2:4] - q[:, 0:2], dim=1)
    overlap = torch.where(cut & (inner >= -EPS) & (union * qlen >= 1.0),
                          inner / union.clamp_min(EPS),
                          torch.zeros_like(inner))

    # depths of the plane-ray intersections: a ray of one segment against
    # the plane through the other segment and its camera centre
    n_v, n_u = T["normal"][v], T["normal"][u]
    base = T["C"][u] - T["C"][v]
    num_p = n_u @ base                                     # (S,) per target
    num_q = -(n_v @ base)                                  # (S,) per source
    den_p1 = T["r1"][v] @ n_u.T                            # (S, S)
    den_p2 = T["r2"][v] @ n_u.T
    den_q1 = n_v @ T["r1"][u].T
    den_q2 = n_v @ T["r2"][u].T

    def ahead(num, den):
        return (den.abs() > EPS) & (num * den > 0)

    valid = ((overlap > o["epipolar_overlap"])
             & ahead(num_p[None, :], den_p1) & ahead(num_p[None, :], den_p2)
             & ahead(num_q[:, None], den_q1) & ahead(num_q[:, None], den_q2)
             & mask[v][:, None] & mask[u][None, :])
    best, tgt = torch.where(valid, overlap, torch.full_like(overlap, -1.0)
                            ).topk(o["knn"], dim=1)
    ok = best > 0.0
    d1 = num_p[tgt] / den_p1.gather(1, tgt)
    d2 = num_p[tgt] / den_p2.gather(1, tgt)
    zero = torch.zeros_like(d1)
    return (torch.where(ok, tgt, torch.zeros_like(tgt)), ok,
            torch.where(ok, d1, zero), torch.where(ok, d2, zero))


def score_view(v, d1, d2, valid, T, o):
    """Scores (S, M) and the slots that pass the orientation test, for
    view v's matches (S, M), M grouped by neighbour."""
    S, M = d1.shape
    k = o["knn"]
    C, kv = T["C"][v], T["k_reg"][v]
    tv = T["nbr"][v].repeat_interleave(k)                  # (M,)
    Ct, kt = T["C"][tv], T["k_reg"][tv]
    group = torch.arange(M, device=d1.device) // k
    other = group[:, None] != group[None, :]
    deg, tsa = o["deg"], o["two_sig_a_sqr"]
    score = torch.zeros_like(d1)
    ok_all = torch.zeros_like(valid)
    block = max(1, PAIR_BLOCK // (M * M))
    for lo in range(0, S, block):
        sl = slice(lo, min(lo + block, S))
        r1, r2 = T["r1"][v, sl, None], T["r2"][v, sl, None]
        P1 = C + r1 * d1[sl, :, None]                      # (B, M, 3)
        P2 = C + r2 * d2[sl, :, None]
        D = P2 - P1
        L = torch.linalg.vector_norm(D, dim=-1)
        u = D / L.clamp_min(EPS)[..., None]
        ok = valid[sl] & (L > EPS)
        if o["check_match_orientation"]:
            ang = torch.arccos((u * T["rmid"][v, sl, None]).sum(-1).clamp(
                -1.0, 1.0))
            ok = ok & (ang > PI_1_32) & (ang < PI_31_32)
        s1 = (d1[sl] * kv) ** 2 + (torch.linalg.vector_norm(
            P1 - Ct, dim=-1) * kt) ** 2
        s2 = (d2[sl] * kv) ** 2 + (torch.linalg.vector_norm(
            P2 - Ct, dim=-1) * kt) ** 2
        a = torch.arccos((u @ u.transpose(1, 2)).clamp(-1.0, 1.0)) * deg
        a = torch.minimum(a, 180.0 - a)
        e1 = d1[sl, :, None] - d1[sl, None, :]
        e2 = d2[sl, :, None] - d2[sl, None, :]
        sim = torch.minimum(
            torch.exp(-a * a / tsa),
            torch.minimum(torch.exp(-e1 * e1 / s1.clamp_min(EPS)[..., None]),
                          torch.exp(-e2 * e2 / s2.clamp_min(EPS)[..., None])))
        sim = torch.where((sim > o["min_similarity_3d"]) & ok[:, :, None]
                          & ok[:, None, :] & other, sim,
                          torch.zeros_like(sim))
        best = sim.reshape(sim.shape[0], M, M // k, k).amax(-1).sum(-1)
        score[sl] = torch.where(ok, best, torch.zeros_like(best))
        ok_all[sl] = ok
    return score, ok_all


def affinities(T, out, o):
    """Affinity weights and validity (V, S, M) of every kept match whose
    target also has an estimate."""
    k = o["knn"]
    tv = T["nbr"].repeat_interleave(k, dim=1)[:, None, :].expand_as(
        out["tgt"])
    ts = out["tgt"]
    A1, A2 = out["est_P1"][:, :, None], out["est_P2"][:, :, None]
    a1, a2 = out["est_d1"][:, :, None], out["est_d2"][:, :, None]
    B1, B2 = out["est_P1"][tv, ts], out["est_P2"][tv, ts]
    b1, b2 = out["est_d1"][tv, ts], out["est_d2"][tv, ts]
    la = torch.linalg.vector_norm(A2 - A1, dim=-1)
    lb = torch.linalg.vector_norm(B2 - B1, dim=-1)
    ua = (A2 - A1) / la.clamp_min(EPS)[..., None]
    ub = (B2 - B1) / lb.clamp_min(EPS)[..., None]
    ok = (out["est_valid"][:, :, None] & out["est_valid"][tv, ts]
          & out["kept"] & (la > EPS) & (lb > EPS))
    ang = torch.arccos((ua * ub).sum(-1).clamp(-1.0, 1.0)) * o["deg"]
    ang = torch.minimum(ang, 180.0 - ang)
    sim = torch.exp(-ang * ang / o["two_sig_a_sqr"])

    md = out["median_depth"]
    cut = scene_cut(md)
    cut_a = torch.clamp_max(md, cut)[:, None, None]
    cut_b = torch.clamp_max(md, cut)[tv]
    ka = T["k_reg"][:, None, None]
    kb = T["k_reg"][tv]

    def dist(P, L0, u):
        w, u = torch.broadcast_tensors(P - L0, u)
        return torch.linalg.vector_norm(torch.linalg.cross(w, u, dim=-1),
                                        dim=-1)

    for d, sig in ((dist(A1, B1, ub), torch.minimum(a1, cut_a) * ka),
                   (dist(A2, B1, ub), torch.minimum(a2, cut_a) * ka),
                   (dist(B1, A1, ua), torch.minimum(b1, cut_b) * kb),
                   (dist(B2, A1, ua), torch.minimum(b2, cut_b) * kb)):
        sim = torch.minimum(sim, torch.exp(-d * d / (2.0 * sig * sig)
                                           .clamp_min(EPS)))
    valid = ok & (sim > o["min_affinity"])
    return torch.where(valid, sim, torch.zeros_like(sim)), valid


def median_depths(d1, d2, valid):
    """The upper median of each view's estimate depths (both endpoints),
    EPS for a view with none (line3D.cc:1657-1668)."""
    out = []
    for v in range(d1.shape[0]):
        x = torch.cat([d1[v][valid[v]], d2[v][valid[v]]]).sort().values
        out.append(x[len(x) // 2] if len(x) else torch.tensor(
            EPS, dtype=d1.dtype, device=d1.device))
    return torch.stack(out)


def scene_cut(median_depth: torch.Tensor) -> torch.Tensor:
    """The median scene depth (the upper median of the views' median
    depths above EPS) that caps the affinities' regularisers; infinity
    where no view has one (line3D.cc:1758-1774)."""
    x = median_depth[median_depth > EPS].sort().values
    if not len(x):
        return torch.tensor(math.inf, dtype=median_depth.dtype,
                            device=median_depth.device)
    return x[len(x) // 2]


def run(scene, o, device) -> dict:
    """The step's outputs on ``scene`` (:class:`scene.Scene`), as float64
    tensors on ``device``: ``tgt``, ``valid`` (matches), ``score``,
    ``score_ok``, ``kept``, ``est_valid``, ``est_P1``, ``est_P2``,
    ``est_d1``, ``est_d2``, ``median_depth``, ``aff_weight``,
    ``aff_valid``, the slots (V, S, M) grouped by neighbour."""
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=device)
    T = {n: f64(getattr(scene, n)) for n in ("segs", "RtKinv", "C", "k_reg")}
    T["mask"] = torch.as_tensor(scene.mask, device=device)
    T["nbr"] = torch.as_tensor(scene.nbr, device=device)
    Rt = T["RtKinv"][:, None]
    T["r1"] = rays(Rt, T["segs"][..., 0:2])
    T["r2"] = rays(Rt, T["segs"][..., 2:4])
    T["rmid"] = rays(Rt, 0.5 * (T["segs"][..., 0:2] + T["segs"][..., 2:4]))
    T["normal"] = _unit(torch.linalg.cross(T["r1"], T["r2"], dim=-1))
    F = f64(scene.F)

    V, S = scene.mask.shape
    N, k = scene.nbr.shape[1], o["knn"]
    M = N * k
    tgt = torch.zeros((V, S, M), dtype=torch.int64, device=device)
    valid = torch.zeros((V, S, M), dtype=torch.bool, device=device)
    d1 = torch.zeros((V, S, M), dtype=torch.float64, device=device)
    d2 = torch.zeros_like(d1)
    for v in range(V):
        for g in np.flatnonzero(scene.pair_valid[v]):
            sl = slice(g * k, (g + 1) * k)
            tgt[v, :, sl], valid[v, :, sl], d1[v, :, sl], d2[v, :, sl] = \
                match_pair(v, int(scene.nbr[v, g]), F[v, g], T, o)

    score = torch.zeros_like(d1)
    score_ok = torch.zeros_like(valid)
    for v in range(V):
        score[v], score_ok[v] = score_view(v, d1[v], d2[v], valid[v], T, o)

    s = torch.where(score_ok, score, torch.zeros_like(score))
    top = s.amax(dim=(1, 2))[:, None, None]
    kept = score_ok & (s > 0.0) & (s > o["min_best_score_perc"] * top)
    best = torch.where(kept, s, torch.zeros_like(s)).argmax(-1, keepdim=True)
    est_valid = kept.any(-1) & (s.gather(-1, best)[..., 0]
                                > o["min_best_score_3d"])
    kept = kept & est_valid[..., None]
    ed1, ed2 = d1.gather(-1, best)[..., 0], d2.gather(-1, best)[..., 0]
    out = dict(tgt=tgt, valid=valid, score=score, score_ok=score_ok,
               kept=kept, est_valid=est_valid, est_d1=ed1, est_d2=ed2,
               est_P1=T["C"][:, None] + T["r1"] * ed1[..., None],
               est_P2=T["C"][:, None] + T["r2"] * ed2[..., None])
    out["median_depth"] = median_depths(ed1, ed2, est_valid)
    out["aff_weight"], out["aff_valid"] = affinities(T, out, o)
    return out
