"""Golden-output parsing and tolerance metrics (a copy of
``line3dpp_tpu.utils.golden``).

The reference ships golden reconstructions for its bundled testdata
(`testdata/Line3D++_ref/*.txt`, format documented in reference README.md:272-277):
each row is one 3D line::

    n  P1x P1y P1z Q1x Q1y Q1z ... (n 3D segments)
    m  camID segID p1x p1y q1x q1y ... (m 2D residuals)

Since kNN tie-breaking and parallel edge ordering make the reference itself
non-bit-reproducible, parity is measured with recall/precision between 3D
segment sets under a distance tolerance (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GoldenLine:
    segments3d: np.ndarray    # (n, 6) [P|Q]
    residuals: np.ndarray     # (m, 6) [camID segID p1x p1y q1x q1y]


def parse_lines3d_txt(path: str) -> list[GoldenLine]:
    lines = []
    with open(path) as f:
        for row in f:
            vals = row.split()
            if not vals:
                continue
            n = int(vals[0])
            seg = np.array(vals[1 : 1 + 6 * n], dtype=np.float64).reshape(n, 6)
            off = 1 + 6 * n
            m = int(vals[off])
            res = np.array(vals[off + 1 : off + 1 + 6 * m], dtype=np.float64).reshape(m, 6)
            lines.append(GoldenLine(segments3d=seg, residuals=res))
    return lines


def _sample_points(segments: np.ndarray, samples_per_seg: int = 8) -> np.ndarray:
    """Uniformly sample points along each 3D segment (N,6) -> (N*s, 3)."""
    p = segments[:, :3]
    q = segments[:, 3:]
    ts = np.linspace(0.0, 1.0, samples_per_seg)[None, :, None]
    pts = p[:, None, :] * (1 - ts) + q[:, None, :] * ts
    return pts.reshape(-1, 3)


def _point_to_segments_dist(points: np.ndarray, segments: np.ndarray,
                            chunk: int = 2048) -> np.ndarray:
    """Min distance of each point (N,3) to any segment (M,6) -> (N,)."""
    p = segments[:, :3]
    d = segments[:, 3:] - p
    len2 = np.maximum((d * d).sum(-1), 1e-18)
    out = np.full(points.shape[0], np.inf)
    for s in range(0, points.shape[0], chunk):
        pts = points[s : s + chunk]
        w = pts[:, None, :] - p[None, :, :]
        t = np.clip((w * d[None]).sum(-1) / len2[None], 0.0, 1.0)
        closest = p[None] + t[..., None] * d[None]
        dist = np.linalg.norm(pts[:, None, :] - closest, axis=-1)
        out[s : s + chunk] = dist.min(axis=1)
    return out


def segment_set_metrics(
    pred: np.ndarray,
    gold: np.ndarray,
    tol: float,
    samples_per_seg: int = 8,
) -> dict:
    """Symmetric coverage metrics between two 3D segment sets (N,6)/(M,6).

    recall    = fraction of golden segment length within `tol` of a prediction
    precision = fraction of predicted segment length within `tol` of golden
    """
    if len(pred) == 0 or len(gold) == 0:
        return {"recall": 0.0, "precision": 0.0, "f1": 0.0}
    gold_pts = _sample_points(gold, samples_per_seg)
    pred_pts = _sample_points(pred, samples_per_seg)
    # length-weight each sample by its segment length / samples
    gold_w = np.repeat(np.linalg.norm(gold[:, 3:] - gold[:, :3], axis=1), samples_per_seg)
    pred_w = np.repeat(np.linalg.norm(pred[:, 3:] - pred[:, :3], axis=1), samples_per_seg)

    d_gold = _point_to_segments_dist(gold_pts, pred)
    d_pred = _point_to_segments_dist(pred_pts, gold)

    recall = float((gold_w * (d_gold < tol)).sum() / max(gold_w.sum(), 1e-12))
    precision = float((pred_w * (d_pred < tol)).sum() / max(pred_w.sum(), 1e-12))
    f1 = 2 * recall * precision / max(recall + precision, 1e-12)
    return {"recall": recall, "precision": precision, "f1": f1}


def line_match_metrics(
    pred_lines: list[np.ndarray],
    gold_lines: list[np.ndarray],
    tol: float,
    coverage_t: float = 0.8,
    samples_per_seg: int = 8,
) -> dict:
    """One-to-one line-level matching between two sets of 3D lines.

    Each line is an (n, 6) array of 3D segments.  A golden line can be
    claimed by at most ONE predicted line and counts as matched when that
    single prediction covers >= ``coverage_t`` of its length within
    ``tol``.  Unlike the length-weighted set metrics, this penalizes
    granularity mismatches: a prediction that merges three golden lines
    can match only one of them (VERDICT round-1 weak item 3: 1511 emitted
    vs 2489 golden lines).

    The assignment is a MAXIMUM bipartite matching (augmenting paths over
    the cov >= coverage_t incidence graph, greedy-seeded).  In dense
    bundles of near-identical parallel golden lines (separation < tol,
    common on the testdata facades) many goldens and preds mutually cover
    each other; the previous greedy-by-coverage assignment left ~4% of
    matchable goldens unmatched purely through assignment order (measured:
    1958 vs 2067 matched on identical round-2 outputs).

    Returns count_recall (matched golden / golden), count_precision
    (claiming preds / preds) and count_f1.
    """
    if not pred_lines or not gold_lines:
        return {"count_recall": 0.0, "count_precision": 0.0, "count_f1": 0.0}
    match_of_g, match_of_p = _line_match(pred_lines, gold_lines, tol,
                                         coverage_t, samples_per_seg)
    count_recall = float((match_of_g >= 0).mean())
    count_precision = float((match_of_p >= 0).sum() / len(pred_lines))
    f1 = (2 * count_recall * count_precision
          / max(count_recall + count_precision, 1e-12))
    return {"count_recall": count_recall, "count_precision": count_precision,
            "count_f1": f1}


def line_match_assignment(pred_lines, gold_lines, tol, coverage_t=0.8,
                          samples_per_seg=8) -> dict:
    """The maximum 1-1 matching itself: {golden index -> pred index}."""
    if not pred_lines or not gold_lines:
        return {}
    match_of_g, _ = _line_match(pred_lines, gold_lines, tol, coverage_t,
                                samples_per_seg)
    return {int(i): int(j) for i, j in enumerate(match_of_g) if j >= 0}


def _line_match(pred_lines, gold_lines, tol, coverage_t, samples_per_seg):
    # coverage[i, j] = fraction of golden line i's length within tol of
    # predicted line j
    gold_pts, gold_w, gold_of = [], [], []
    for i, g in enumerate(gold_lines):
        pts = _sample_points(g, samples_per_seg)
        w = np.repeat(np.linalg.norm(g[:, 3:] - g[:, :3], axis=1),
                      samples_per_seg) / samples_per_seg
        gold_pts.append(pts)
        gold_w.append(w)
        gold_of.append(np.full(len(pts), i))
    P = np.concatenate(gold_pts)
    Wt = np.concatenate(gold_w)
    Gi = np.concatenate(gold_of)
    n_g, n_p = len(gold_lines), len(pred_lines)

    cov = np.zeros((n_g, n_p))
    tot = np.zeros(n_g)
    np.add.at(tot, Gi, Wt)
    for j, pl_ in enumerate(pred_lines):
        d = _point_to_segments_dist(P, pl_)
        np.add.at(cov[:, j], Gi, Wt * (d < tol))
    cov /= np.maximum(tot[:, None], 1e-12)

    # maximum one-to-one assignment: greedy seed by descending coverage,
    # then augmenting paths (iterative DFS) to optimality
    match_of_g = np.full(n_g, -1, np.int64)      # golden i -> pred j
    match_of_p = np.full(n_p, -1, np.int64)      # pred j -> golden i
    order = np.argsort(-cov, axis=None)
    for flat in order:
        i, j = divmod(int(flat), n_p)
        if cov[i, j] < coverage_t:
            break
        if match_of_g[i] < 0 and match_of_p[j] < 0:
            match_of_g[i] = j
            match_of_p[j] = i
    adj = [np.where(cov[i] >= coverage_t)[0] for i in range(n_g)]

    def _augment(start: int) -> bool:
        # iterative DFS for an augmenting path from unmatched golden `start`
        seen = set()
        stack = [(start, 0)]
        parent: dict[int, tuple[int, int]] = {}   # pred j -> (golden, prev j)
        while stack:
            gi, ptr = stack.pop()
            a = adj[gi]
            while ptr < len(a):
                j = int(a[ptr])
                ptr += 1
                if j in seen:
                    continue
                seen.add(j)
                parent[j] = (gi, ptr)
                owner = int(match_of_p[j])
                if owner < 0:
                    # augment: flip the path back to start
                    while True:
                        gi2, _ = parent[j]
                        prev = int(match_of_g[gi2])
                        match_of_g[gi2] = j
                        match_of_p[j] = gi2
                        if gi2 == start:
                            return True
                        j = prev
                stack.append((gi, ptr))
                stack.append((owner, 0))
                break
        return False

    for i in range(n_g):
        if match_of_g[i] < 0 and len(adj[i]):
            _augment(i)

    return match_of_g, match_of_p


def stack_golden_segments(lines: list[GoldenLine]) -> np.ndarray:
    return np.concatenate([l.segments3d for l in lines], axis=0)


def scene_scale(segments: np.ndarray) -> float:
    """Characteristic scene size: diagonal of the segment bounding box."""
    pts = np.concatenate([segments[:, :3], segments[:, 3:]], axis=0)
    return float(np.linalg.norm(pts.max(0) - pts.min(0)))


def nearest_segment(a: np.ndarray, b: np.ndarray):
    """For each 2D segment of ``a`` (n, 4) the nearest segment of ``b``
    (m, 4): ``(dist (n,), index (n,))``, the distance being the larger of
    the two endpoint distances in the better orientation (inf and -1 when
    ``b`` is empty)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    if len(b) == 0:
        return np.full(len(a), np.inf), np.full(len(a), -1)

    def d(p, q):          # (len(a), len(b)) endpoint distances
        return np.linalg.norm(p[:, None, :] - q[None, :, :], axis=-1)

    same = np.maximum(d(a[:, :2], b[:, :2]), d(a[:, 2:], b[:, 2:]))
    flip = np.maximum(d(a[:, :2], b[:, 2:]), d(a[:, 2:], b[:, :2]))
    best = np.minimum(same, flip)
    index = best.argmin(1)
    return best[np.arange(len(a)), index], index


def endpoint_coverage(a: np.ndarray, b: np.ndarray, tol: float = 1.0) -> float:
    """Share of the 2D segments ``a`` (n, 4) that have a segment in ``b``
    with both endpoints within ``tol`` pixels, in either orientation (1.0
    when ``a`` is empty).  Mutual coverage is the smaller of the two
    directions."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    if len(a) == 0:
        return 1.0
    return float((nearest_segment(a, b)[0] <= tol).mean())


def mutual_coverage(a: np.ndarray, b: np.ndarray,
                    tol: float = 1.0) -> tuple[float, float, int]:
    """Mutual endpoint coverage of two 2D segment sets of one view:
    ``(coverage, covered, n)``, the smaller of the two directions'
    coverage, the segments it covers and the larger set's size.  Summed
    over views, ``covered / n`` is the coverage over all views."""
    fwd = endpoint_coverage(a, b, tol)
    back = endpoint_coverage(b, a, tol)
    return (min(fwd, back), min(fwd * len(a), back * len(b)),
            max(len(a), len(b)))
