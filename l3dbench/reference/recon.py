"""The reconstruction of one scene from the step's outputs, in float64,
written from Line3D++ (line3D.cc:1852-2452):

- the affinity edges of the kept matches, and with ``collinearity_t > 0``
  the same-view collinearity edges (View::findCollinearSegments
  view.cc:212-264, edges line3D.cc:1904-1974), each undirected pair once;
- with ``perform_rdd``, replicator-dynamics diffusion of the weights
  (performRDD line3D.cc:2026-2076);
- Felzenszwalb's clustering with c = ``felzenszwalb_c``
  (clustering.cc:6-48): edges in ascending weight, a merge where the
  weight is within both components' thresholds, the threshold then
  weight + c / size;
- clusters seen from ``visibility`` distinct views, each fitted with the
  centre of gravity and principal axis of its members' estimate endpoints
  (get3DlineFromCluster line3D.cc:2155-2218), bundled (``bundle.py``)
  where ``optimize`` is on;
- each member's segment projected onto its cluster's line
  (project2DsegmentOnto3Dline line3D.cc:2221-2266), the sweep that keeps
  the stretches seen by ``visibility`` distinct views at once
  (findCollinearSegments line3D.cc:2342-2452), and the filter of stretches
  shorter than ``min_line_length_factor`` of the diagonal in the view of
  the cluster's longest member (line3D.cc:2302-2339).

It reads the step's outputs that the program produced (its stage
boundary: the reference follows the program from its step's state), and
everything else from the scene it set up itself.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from . import bundle
from .scene import tf32

EPS = 1e-12
STATE_FLOATS = ("est_P1", "est_P2", "est_d1", "est_d2", "aff_weight",
                "median_depth")


def point_line_2d(px, py, x1, y1, x2, y2):
    """Distance of (px, py) to the line through (x1, y1) and (x2, y2)."""
    dx, dy = x2 - x1, y2 - y1
    return np.abs(dx * (y1 - py) - dy * (x1 - px)) / np.maximum(
        np.hypot(dx, dy), EPS)


def collinear_edges(scene, st, o):
    """(view, i, j, weight) of each collinear pair i < j whose estimates
    agree: all four endpoint-to-line distances under ``collinearity_t``
    pixels, no overlap along segment j, and a position similarity above
    ``min_affinity`` (the angle term is left out for collinear pairs,
    line3D.cc:1460-1465)."""
    md = st["median_depth"]
    pos = np.sort(md[md > EPS])
    cut = pos[len(pos) // 2] if len(pos) else np.inf
    out = []
    for v in range(scene.V):
        idx = np.flatnonzero(scene.mask[v] & st["est_valid"][v])
        x1, y1, x2, y2 = (scene.segs[v, idx, c] for c in range(4))
        R = lambda a: a[:, None]                       # noqa: E731 row i
        Cc = lambda a: a[None, :]                      # noqa: E731 column j
        dmax = np.maximum.reduce([
            point_line_2d(R(x1), R(y1), Cc(x1), Cc(y1), Cc(x2), Cc(y2)),
            point_line_2d(R(x2), R(y2), Cc(x1), Cc(y1), Cc(x2), Cc(y2)),
            point_line_2d(Cc(x1), Cc(y1), R(x1), R(y1), R(x2), R(y2)),
            point_line_2d(Cc(x2), Cc(y2), R(x1), R(y1), R(x2), R(y2))])
        dx, dy = x2 - x1, y2 - y1
        l2 = np.maximum(dx * dx + dy * dy, EPS)
        ta = ((R(x1) - Cc(x1)) * Cc(dx) + (R(y1) - Cc(y1)) * Cc(dy)) / Cc(l2)
        tb = ((R(x2) - Cc(x1)) * Cc(dx) + (R(y2) - Cc(y1)) * Cc(dy)) / Cc(l2)
        overlaps = (np.maximum(np.minimum(ta, tb), 0.0)
                    <= np.minimum(np.maximum(ta, tb), 1.0))
        cand = ((dmax < o["collinearity_t"]) & ~overlaps
                & np.triu(np.ones((len(idx),) * 2, bool), 1))
        i, j = np.nonzero(cand)
        if not len(i):
            continue
        P1, P2 = st["est_P1"][v, idx], st["est_P2"][v, idx]
        u = P2 - P1
        u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), EPS)
        capped = min(md[v], cut)
        s1 = np.minimum(st["est_d1"][v, idx], capped) * scene.k_reg[v]
        s2 = np.minimum(st["est_d2"][v, idx], capped) * scene.k_reg[v]

        def off(P, b):
            # distance of the points P to the lines of segments b
            return np.linalg.norm(np.cross(P - P1[b], u[b]), axis=1)

        sim = np.minimum.reduce([
            np.exp(-off(P1[i], j) ** 2 / np.maximum(2 * s1[i] ** 2, EPS)),
            np.exp(-off(P2[i], j) ** 2 / np.maximum(2 * s2[i] ** 2, EPS)),
            np.exp(-off(P1[j], i) ** 2 / np.maximum(2 * s1[j] ** 2, EPS)),
            np.exp(-off(P2[j], i) ** 2 / np.maximum(2 * s2[j] ** 2, EPS))])
        keep = sim > o["min_affinity"]
        out.append((np.full(keep.sum(), v), idx[i[keep]], idx[j[keep]],
                    sim[keep]))
    if not out:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros(0)
    return tuple(np.concatenate(x) for x in zip(*out))


def diffuse(li, lj, w, n, iterations: int) -> np.ndarray:
    """Replicator dynamics on the symmetric matrix of the edges:
    P = rows(W), then ``iterations`` times P = rows(P o (P W)), and each
    edge's min(P_ij, P_ji)."""
    W = scipy.sparse.coo_matrix((np.concatenate([w, w]),
                                 (np.concatenate([li, lj]),
                                  np.concatenate([lj, li]))),
                                shape=(n, n)).tocsr()

    def rows(A):
        s = np.asarray(A.sum(1)).ravel()
        return scipy.sparse.diags(1.0 / np.maximum(s, EPS)) @ A

    P = rows(W)
    for _ in range(iterations):
        P = rows(P.multiply(P @ W).tocsr())
    P = P.tocsr()
    return np.minimum(np.asarray(P[li, lj]).ravel(),
                      np.asarray(P[lj, li]).ravel())


def felzenszwalb(ei, ej, w, n, c) -> np.ndarray:
    """A component label per node; the edges are visited in ascending
    weight, equal weights in the given order."""
    parent = list(range(n))
    size = [1] * n
    thr = [float(c)] * n

    def root(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    order = np.argsort(w, kind="stable")
    for i, j, we in zip(ei[order].tolist(), ej[order].tolist(),
                        w[order].tolist()):
        a, b = root(i), root(j)
        if a != b and we <= thr[a] and we <= thr[b]:
            if size[a] < size[b]:
                a, b = b, a
            parent[b] = a
            size[a] += size[b]
            thr[a] = we + c / size[a]
    return np.array([root(x) for x in range(n)])


def sweep(s1, s2, cams, visibility):
    """The stretches [(start, end)] of one cluster's line that at least
    ``visibility`` distinct cameras see at once: the members' intervals
    swept from the border (the endpoint farthest from the centre, s = 1)
    inward."""
    params = np.concatenate([s1, s2])
    m = len(s1)
    far = np.abs(params - 1.0)
    border = params[max(range(2 * m), key=lambda e: (far[e], e))]
    order = sorted(range(2 * m), key=lambda e: (abs(params[e] - border), e))
    opened, count, seen = set(), {}, 0
    out, start = [], None
    for e in order:
        line, cam = e % m, cams[e % m]
        if line not in opened:
            opened.add(line)
            count[cam] = count.get(cam, 0) + 1
            seen += count[cam] == 1
        else:
            count[cam] -= 1
            seen -= count[cam] == 0
        if seen >= visibility and start is None:
            start = params[e]
        elif seen < visibility and start is not None:
            out.append((start, params[e]))
            start = None
    return out


def run(scene, state: dict, o: dict, device, precision: str = "fp32"):
    """The 3D line segments (n, 6), world frame, that the scene's
    reconstruction gives from the step outputs ``state`` (numpy: the
    program's ``tgt_seg``, ``aff_weight``, ``aff_valid``, ``est_*``,
    ``median_depth`` and ``neighbor_ids``).  With ``"tf32"`` the state's
    floats are rounded to TF32 first (the control)."""
    st = {k: (np.asarray(v, np.float64) if k in STATE_FLOATS
              else np.asarray(v)) for k, v in state.items()}
    if precision == "tf32":
        st.update({k: tf32(st[k]) for k in STATE_FLOATS})
    V, S = scene.mask.shape
    k = o["knn"]
    v, s, m = np.nonzero(st["aff_valid"])
    a = v * S + s
    b = st["neighbor_ids"][v, m // k].astype(np.int64) * S \
        + st["tgt_seg"][v, s, m]
    w = st["aff_weight"][v, s, m]
    if o["collinearity_t"] > 0:
        cv, ci, cj, cw = collinear_edges(scene, st, o)
        a = np.concatenate([a, cv * S + ci])
        b = np.concatenate([b, cv * S + cj])
        w = np.concatenate([w, cw])
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    _, first = np.unique(lo * (V * S) + hi, return_index=True)
    lo, hi, w = lo[first], hi[first], w[first]
    if not len(w):
        return np.zeros((0, 6))
    nodes, inv = np.unique(np.concatenate([lo, hi]), return_inverse=True)
    li, lj = inv[:len(lo)], inv[len(lo):]
    if o["perform_rdd"]:
        w = diffuse(li, lj, w, len(nodes), o["rdd_max_iter"])
    label = felzenszwalb(np.concatenate([li, lj]), np.concatenate([lj, li]),
                         np.concatenate([w, w]), len(nodes),
                         o["felzenszwalb_c"])

    view, seg = nodes // S, nodes % S
    views_of = {}
    for lab, vv in zip(label, view):
        views_of.setdefault(lab, set()).add(vv)
    kept = sorted(lab for lab, vs in views_of.items()
                  if len(vs) >= o["visibility"])
    cid = {lab: i for i, lab in enumerate(kept)}
    member = np.array([lab in cid for lab in label], bool)
    mc = np.array([cid[lab] for lab in label[member]], np.int64)
    mv, ms = view[member], seg[member]
    C = len(kept)
    if not C:
        return np.zeros((0, 6))

    # centre of gravity and principal axis of the members' endpoints
    pts = np.concatenate([st["est_P1"][mv, ms], st["est_P2"][mv, ms]])
    pc = np.concatenate([mc, mc])
    cog = np.zeros((C, 3))
    np.add.at(cog, pc, pts)
    cog /= np.bincount(pc, minlength=C)[:, None]
    dev = pts - cog[pc]
    scatter = np.zeros((C, 3, 3))
    np.add.at(scatter, pc, dev[:, :, None] * dev[:, None, :])
    axis = np.linalg.eigh(scatter)[1][:, :, 2]
    P1, P2, u = cog - axis, cog + axis, axis

    segs = scene.segs
    if o["optimize"]:
        t64 = lambda x, dt=torch.float64: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(x), dtype=dt, device=device)
        tc = -np.einsum("vij,vj->vi", scene.R, scene.C)
        q = segs[mv, ms]
        one = np.ones((len(q), 1))
        sd = q[:, 2:4] - q[:, 0:2]
        sd /= np.maximum(np.linalg.norm(sd, axis=1, keepdims=True), EPS)
        obs = (t64(np.linalg.inv(scene.K[mv]).transpose(0, 2, 1)),
               t64(scene.R[mv]), t64(tc[mv]),
               t64(np.concatenate([q[:, 0:2], one], 1)),
               t64(np.concatenate([q[:, 2:4], one], 1)), t64(sd))
        Q1, Q2, U = bundle.optimize(t64(P1), t64(P2), t64(mc, torch.int64),
                                    obs, int(o["max_iter_optim"]))
        P1, u = Q1.cpu().numpy(), U.cpu().numpy()

    # each member's segment on its line: the closest points of the line
    # to the rays through the segment's endpoints
    def on_line(ray):
        L0, d, c = P1[mc], u[mc], scene.C[mv]
        w0 = L0 - c
        aa, bb, cc = (d * d).sum(1), (d * ray).sum(1), (ray * ray).sum(1)
        dd, ee = (d * w0).sum(1), (ray * w0).sum(1)
        den = aa * cc - bb * bb
        ok = np.abs(den) > 1e-12
        return (bb * ee - cc * dd) / np.where(ok, den, 1.0), ok

    def ray_of(xy):
        r = np.einsum("nij,nj->ni", scene.RtKinv[mv],
                      np.concatenate([xy, np.ones((len(xy), 1))], 1))
        return r / np.linalg.norm(r, axis=1, keepdims=True)

    q = segs[mv, ms]
    s1, ok1 = on_line(ray_of(q[:, 0:2]))
    s2, ok2 = on_line(ray_of(q[:, 2:4]))
    ok = ok1 & ok2
    lens = np.hypot(q[:, 2] - q[:, 0], q[:, 3] - q[:, 1])

    rows = []
    for c in range(C):
        mem = np.flatnonzero(mc == c)
        good = mem[ok[mem]]
        if len(good) < 3:
            continue
        ref = mv[mem[np.argmax(lens[mem])]]        # first longest member
        for sa, sb in sweep(s1[good], s2[good], mv[good], o["visibility"]):
            A = P1[c] + sa * u[c] + scene.translation
            B = P1[c] + sb * u[c] + scene.translation

            def px(X):
                y = scene.K[ref] @ (scene.R[ref] @ X + scene.t[ref])
                return y[:2] / y[2]
            if np.linalg.norm(px(A) - px(B)) > (
                    scene.diagonal[ref] * o["min_line_length_factor"]):
                rows.append(np.concatenate([A, B]))
    return np.array(rows).reshape(-1, 6)
