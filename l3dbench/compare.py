"""The comparison that decides ``correct``: the numbers that set the
program's outputs of one scene against the reference's, stage by stage.

The step, against the reference's step on the same inputs.  A match is a
(view, segment, neighbour view, target segment) that the step keeps; the
two sides' slots may hold their matches in another order.

- ``matches_differ``: the matches that one side keeps and the other not;
- ``scores_off``: of the matches both keep, those whose 3D score differs
  by more than ``TOL``;
- ``affinities_off``: of the matches both keep, those whose affinity
  weight (0 where the edge is not valid) differs by more than ``TOL``.

The reconstruction, against the reference's reconstruction from the
program's own step outputs:

- ``lines_gap``: the largest distance of an endpoint of a 3D line
  segment of either side to the nearest segment of the other side, over
  the scene's scale (the diagonal of the reference's segments' bounding
  box): a line that one side lacks or has elsewhere shows in it, and so
  does a discrete decision that float32 rounding moves (a sweep or
  tiny-segment cut, a cluster merge under diffused weights);
- ``lines_gap_p99``: the 99th percentile of those endpoint distances,
  steady where a scene's few such decisions set the largest;
- ``lines_count_diff``: the difference in 3D line segment counts (printed,
  not compared).

Where the two sides' step tables differ in shape, every step number is
infinite; where the program's step outputs do not cover the scene, so is
every number of the lines.
"""

from __future__ import annotations

import math

import numpy as np

BLOCK = 1024
# a score or an affinity that differs by more than TOL has crossed one of
# the step's thresholds; float32 alone moves them by up to ~1e-2 (an acos
# near 1, depths that cancel)
TOL = 0.1


def point_to_segments(p: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """The distance of each point p (n, 3) to the nearest of the segments
    ``seg`` (m, 6); inf where there is none."""
    if len(seg) == 0:
        return np.full(len(p), np.inf)
    a, d = seg[:, :3], seg[:, 3:] - seg[:, :3]
    dd = np.maximum((d * d).sum(1), 1e-300)
    out = np.empty(len(p))
    for lo in range(0, len(p), BLOCK):
        w = p[lo:lo + BLOCK, None, :] - a[None]            # (b, m, 3)
        t = np.clip((w * d[None]).sum(-1) / dd, 0.0, 1.0)
        out[lo:lo + BLOCK] = np.linalg.norm(w - t[..., None] * d[None],
                                            axis=-1).min(1)
    return out


def endpoint_gaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The distance of every endpoint of either set's segments (n, 6) to
    the other set's segments."""
    a = np.asarray(a, np.float64).reshape(-1, 6)
    b = np.asarray(b, np.float64).reshape(-1, 6)
    ends = lambda x: np.concatenate([x[:, :3], x[:, 3:]])  # noqa: E731
    return np.concatenate([point_to_segments(ends(a), b),
                           point_to_segments(ends(b), a)])


def scene_scale(lines: np.ndarray) -> float:
    if len(lines) == 0:
        return 1.0
    pts = np.concatenate([lines[:, :3], lines[:, 3:]])
    return float(np.linalg.norm(pts.max(0) - pts.min(0))) or 1.0


def match_keys(s: dict) -> tuple[np.ndarray, np.ndarray]:
    """Each kept match's key (view, segment, neighbour view, target
    segment) as one integer, sorted, and its (v, s, m) slot's flat index
    in the same order."""
    V, S, M = s["tgt"].shape
    v, seg, m = np.nonzero(s["valid"])
    tv = np.asarray(s["nbr"])[v, m // int(s["knn"])].astype(np.int64)
    key = ((v.astype(np.int64) * S + seg) * V + tv) * S + s["tgt"][v, seg, m]
    flat = np.ravel_multi_index((v, seg, m), (V, S, M))
    order = np.argsort(key)
    return key[order], flat[order]


def step_numbers(p: dict, r: dict, tol: float = TOL) -> dict:
    if p["tgt"].shape[:2] != r["tgt"].shape[:2]:
        return dict(matches_differ=math.inf, scores_off=math.inf,
                    affinities_off=math.inf)
    kp, fp = match_keys(p)
    kr, fr = match_keys(r)
    common, ip, ir = np.intersect1d(kp, kr, assume_unique=True,
                                    return_indices=True)
    fp, fr = fp[ip], fr[ir]
    w = lambda s, f: np.where(s["aff_valid"].reshape(-1)[f],  # noqa: E731
                              s["aff_weight"].reshape(-1)[f], 0.0)
    ds = np.abs(p["score"].reshape(-1)[fp].astype(np.float64)
                - r["score"].reshape(-1)[fr])
    dw = np.abs(w(p, fp).astype(np.float64) - w(r, fr))
    return dict(matches_differ=int(len(kp) + len(kr) - 2 * len(common)),
                scores_off=int((ds > tol).sum()),
                affinities_off=int((dw > tol).sum()))


def line_numbers(prog_lines: np.ndarray, ref_lines) -> dict:
    if ref_lines is None:
        return dict(lines_gap=math.inf, lines_gap_p99=math.inf,
                    lines_count_diff=math.inf)
    g = endpoint_gaps(prog_lines, ref_lines) / scene_scale(ref_lines)
    return dict(lines_gap=float(g.max(initial=0.0)),
                lines_gap_p99=float(np.quantile(g, 0.99)) if len(g) else 0.0,
                lines_count_diff=int(abs(len(prog_lines) - len(ref_lines))))


def numbers(prog: dict, ref_step: dict, ref_lines: np.ndarray) -> dict:
    """Every number of one scene (see the module's docstring)."""
    return dict(step_numbers(prog["step"], ref_step),
                **line_numbers(prog["lines"], ref_lines))


def judge(per_scene: list[dict], limits: dict) -> tuple[bool, dict]:
    """The largest value over the sampled scenes of each number that
    ``limits`` names, beside its limit, and whether every one is within
    its limit."""
    checks = {name: dict(value=max(s[name] for s in per_scene), limit=lim)
              for name, lim in limits.items()} if per_scene else {}
    ok = bool(per_scene) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    return ok, checks
