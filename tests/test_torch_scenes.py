"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py), and
tests of those inputs.

Every scene is made with numpy from a seed (or read from the bundled
testdata) and handed to both packages as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from line3dpp_tpu_torch.camera import (Camera, CameraBatch,
                                       fundamental_matrix,
                                       median_center_translation,
                                       rotation_from_rpy)

STEP_KW = dict(epipolar_overlap=0.25, knn=4, two_sig_a_sqr=200.0,
               min_similarity=0.5, check_orientation=True,
               min_best_score=0.75, min_best_score_perc=0.10,
               min_affinity=0.5, pair_chunk=4)


def synthetic_step_inputs(seed: int = 0, V: int = 5, S: int = 48,
                          N: int = 3, n_lines: int = 30,
                          noise_px: float = 0.3) -> dict:
    """A small consistent multi-view scene: ``n_lines`` random 3D segments
    seen by V cameras on a line, projected with pixel noise and padded to S
    slots; each view's N nearest cameras are its neighbours.  Returns the
    numpy arguments of ``forward_step`` by name."""
    rng = np.random.default_rng(seed)
    P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(n_lines, 3))
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.8, 1.6, size=(n_lines, 1))
    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    cams = []
    for i in range(V):
        R = rotation_from_rpy(rng.normal() * 0.02, -0.05 * i + 0.12,
                              rng.normal() * 0.02)
        C = np.array([0.5 * i - 1.2, rng.normal() * 0.05,
                      rng.normal() * 0.05])
        cams.append(Camera(K, R, -R @ C, 1920, 1080))

    segs = np.zeros((V, S, 4), np.float32)
    mask = np.zeros((V, S), bool)
    for i, cam in enumerate(cams):
        sv = np.hstack([cam.project(P), cam.project(Q)])
        sv += rng.normal(0.0, noise_px, sv.shape)
        segs[i, : len(sv)] = sv
        mask[i, : len(sv)] = True

    translation = median_center_translation(cams)
    cb = CameraBatch.from_cameras(cams, sigma_p=2.5, translation=translation)
    centered = [Camera(c.K, c.R, -c.R @ (c.C - translation), c.width,
                       c.height) for c in cams]
    neighbor_ids = np.zeros((V, N), np.int32)
    pair_valid = np.zeros((V, N), bool)
    F = np.zeros((V, N, 3, 3), np.float32)
    for i in range(V):
        nbrs = sorted((j for j in range(V) if j != i),
                      key=lambda j: np.linalg.norm(cams[i].C - cams[j].C))
        for g, j in enumerate(nbrs[:N]):
            neighbor_ids[i, g] = j
            pair_valid[i, g] = True
            F[i, g] = fundamental_matrix(centered[i], centered[j])
    return dict(segments=segs, seg_mask=mask, RtKinv=cb.RtKinv, C=cb.C,
                k_reg=cb.k_reg, neighbor_ids=neighbor_ids, F=F,
                pair_valid=pair_valid)


def bundled_step_inputs(cam_ids, max_line_segments: int,
                        num_neighbors: int) -> dict:
    """``Line3D.step_inputs()`` of the port on a subset of the bundled
    testdata views (host numpy only, no device work)."""
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.utils.testdata import load_views

    cfg = lt.Config(optimize=False, max_line_segments=max_line_segments,
                    num_neighbors=num_neighbors)
    pipe = lt.Line3D(cfg, device="cpu")
    for v in load_views(cam_ids):
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    return pipe.step_inputs()


def agreeing_scoring_case(rng, V: int = 6, S: int = 40, N: int = 4,
                          k: int = 5):
    """Scoring inputs in which the hypotheses of one segment agree up to
    noise, so that many slot pairs pass min_similarity and the scores are
    not trivially 0: numpy arrays named as ``score_matches``'s arguments,
    and k."""
    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    M = N * k
    r1 = unit(rng.normal(size=(V, S, 3)))
    r2 = unit(r1 + rng.normal(0, 0.05, (V, S, 3)))
    rmid = unit(r1 + r2 + rng.normal(0, 0.3, (V, S, 3)))
    base = rng.uniform(2.0, 12.0, (V, S, 1))
    d1 = (base + rng.normal(0, 0.01, (V, S, M))).astype(np.float32)
    d2 = (base * rng.uniform(0.9, 1.1, (V, S, 1))
          + rng.normal(0, 0.01, (V, S, M))).astype(np.float32)
    return dict(
        r1=r1, r2=r2, rmid=rmid,
        C=rng.normal(size=(V, 3)).astype(np.float32),
        k_reg=rng.uniform(1e-3, 3e-3, V).astype(np.float32),
        neighbor_ids=rng.integers(0, V, (V, N)).astype(np.int32),
        d_p1=d1, d_p2=d2,
        valid=rng.uniform(size=(V, S, M)) > 0.25), k


def k2_arguments(case: dict, dev="cpu") -> tuple:
    """Kernel K2's positional arguments (``scoring.score_matches_cuda`` and
    ``score_matches_plain``) from an :func:`agreeing_scoring_case` on
    ``dev``: the target cameras gathered by neighbour."""
    nbr = case["neighbor_ids"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (*(t(case[n]) for n in ("r1", "r2", "rmid", "C", "k_reg")),
            t(case["C"][nbr]), t(case["k_reg"][nbr]),
            *(t(case[n]) for n in ("d_p1", "d_p2", "valid")))


def k2_scene_arguments(inp: dict, knn: int, dev="cpu") -> tuple:
    """Kernel K2's positional arguments for a step-input scene, from the
    matcher's table on ``dev`` as ``models/step.py`` builds them."""
    from line3dpp_tpu_torch.models import step
    from line3dpp_tpu_torch.ops import matching

    d = {n: torch.from_numpy(inp[n]).to(dev) for n in (
        "segments", "seg_mask", "RtKinv", "C", "k_reg", "neighbor_ids", "F",
        "pair_valid")}
    V, N = d["neighbor_ids"].shape
    pm = matching.match_pairs(
        d["segments"], d["seg_mask"], d["RtKinv"], d["C"],
        torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(N),
        d["neighbor_ids"].reshape(-1), d["F"].reshape(-1, 3, 3),
        d["pair_valid"].reshape(-1), 0.25, knn)
    return step.score_inputs(d["segments"], d["RtKinv"], d["C"], d["k_reg"],
                             d["neighbor_ids"], pm)


def pair_list(inp: dict):
    """(src_idx, tgt_idx, F, pair_valid) flattened over (view, slot)."""
    V, N = inp["neighbor_ids"].shape
    src = np.repeat(np.arange(V, dtype=np.int32), N)
    return (src, inp["neighbor_ids"].reshape(-1),
            inp["F"].reshape(-1, 3, 3), inp["pair_valid"].reshape(-1))


# ---------------------------------------------------------------- collinear
def broken_line_views(rng, V: int = 3, S: int = 160, fill: bool = False):
    """Segments cut from a few long 2D lines with gaps, jittered by up to
    2 px, plus clutter: many pairs near the 2-px threshold (S >= 136:
    96 pieces of lines and 40 clutter segments a view, then padding).
    ``fill`` draws as many lines as it takes to fill all S rows."""
    segs = np.zeros((V, S, 4), np.float32)
    mask = np.zeros((V, S), bool)
    n_lines = max(12, -(-(S - 40) // 8)) if fill else 12
    for v in range(V):
        rows = []
        for _ in range(n_lines):
            p = rng.uniform(0, 1000, 2)
            d = rng.normal(size=2)
            d /= np.linalg.norm(d)
            t = 0.0
            for _ in range(8):
                a = t + rng.uniform(2, 30)
                b = a + rng.uniform(20, 120)
                j = rng.normal(scale=0.8, size=4)
                rows.append(np.concatenate([p + a * d, p + b * d]) + j)
                t = b
        rows = np.array(rows)[: S - 40]
        clutter = rng.uniform(0, 1000, (40, 4))
        allr = np.vstack([rows, clutter])
        segs[v, : len(allr)] = allr
        mask[v, : len(allr)] = rng.uniform(size=len(allr)) > 0.05
    return segs, mask


def similarity_inputs(rng, V: int = 3, S: int = 120):
    """Estimates along a few 3D lines (so that many pairs pass) and random
    clutter, seeded: P1, P2, d1, d2, valid, a random (V, S, S) pair mask,
    k_reg and the median depths."""
    P1 = rng.normal(size=(V, S, 3)).astype(np.float32) * 2
    P1[..., 2] += 8
    d = rng.normal(size=(V, S, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    base = rng.normal(size=(V, 4, 3)) * 2 + np.array([0, 0, 8])
    bd = rng.normal(size=(V, 4, 3))
    bd /= np.linalg.norm(bd, axis=-1, keepdims=True)
    for v in range(V):
        for i in range(S // 2):
            k = i % 4
            P1[v, i] = base[v, k] + bd[v, k] * rng.uniform(-2, 2) \
                + rng.normal(scale=0.01, size=3)
            d[v, i] = bd[v, k] + rng.normal(scale=0.01, size=3)
    P2 = (P1 + d * rng.uniform(0.3, 1.5, (V, S, 1))).astype(np.float32)
    d1 = np.linalg.norm(P1, axis=-1).astype(np.float32)
    d2 = np.linalg.norm(P2, axis=-1).astype(np.float32)
    valid = rng.uniform(size=(V, S)) > 0.1
    collin = rng.uniform(size=(V, S, S)) > 0.3
    k_reg = rng.uniform(0.002, 0.01, V).astype(np.float32)
    med = rng.uniform(6, 10, V).astype(np.float32)
    return P1, P2, d1, d2, valid, collin, k_reg, med


def test_bundled_loader_matches_jax_cache():
    """The port's loader returns, for all 26 bundled views, the cameras of
    cameras_testdata.json and the segments JAX's cache reader returns."""
    import json
    import os

    from line3dpp_tpu.utils import segments_cache as jax_cache
    from line3dpp_tpu_torch.utils.testdata import TESTDATA_DIR, load_views

    views = load_views()
    assert [v.cam_id for v in views] == list(range(26))
    with open(os.path.join(TESTDATA_DIR, "cameras_testdata.json")) as f:
        cams = json.load(f)
    for v in views:
        c = cams[str(v.cam_id)]
        np.testing.assert_array_equal(v.K, np.array(c["K"]))
        np.testing.assert_array_equal(v.R, np.array(c["R"]))
        np.testing.assert_array_equal(v.t, np.array(c["t"]))
        want = jax_cache.load(os.path.join(TESTDATA_DIR, "L3D_cache"),
                              v.cam_id, (v.height, v.width), 3000)
        np.testing.assert_array_equal(v.segments, want)


def test_synthetic_scene_is_consistent():
    """Every valid view pair of the synthetic scene has a finite F that maps
    a segment endpoint near the epipolar line of its counterpart."""
    inp = synthetic_step_inputs(seed=3, noise_px=0.0)
    V, N = inp["neighbor_ids"].shape
    assert inp["pair_valid"].all()
    for i in range(V):
        for g in range(N):
            j = inp["neighbor_ids"][i, g]
            p = np.append(inp["segments"][i, 0, :2], 1.0)
            q = np.append(inp["segments"][j, 0, :2], 1.0)
            e = inp["F"][i, g].astype(np.float64) @ p
            assert abs(e @ q) / np.hypot(e[0], e[1]) < 0.05   # pixels


# ---------------------------------------------------------------- sweep
SWEEP_CASES = ("random", "sizes", "ties", "one_camera", "many_views",
               "large", "empty", "no_clusters")


def sweep_case(name: str, seed: int = 0) -> dict:
    """Seeded arguments of ``sweep.sweep_clusters`` as numpy arrays: ``r1``,
    ``r2`` (V, S, 3) and ``segs`` (V, S, 4) float32, ``cam_C`` (V, 3)
    float32, ``line_P1`` and ``line_dir`` (C, 3) float64, the members'
    ``mc``, ``mv``, ``ms`` (int32, clusters interleaved in member order)
    and ``C``; ``exact`` (m, 2) holds the parameters that the members of
    the exact clusters project to, NaN elsewhere.

    An exact cluster lies on the line z = zc, y = 0 along x, with integer
    zc, and the cameras at integer (x, -1, z): the ray (t - x, 1, zc - z)
    meets the line at x = t, and for small integer t every step of the
    projection is exact, so ties of |p - 1| and of the distance to the
    border happen as built.  A random cluster has a random line and rays
    towards points near it.  A parallel member's first ray runs along the
    line (a c - b^2 = 0: not kept).

    ``sizes``: exact clusters of 0-4 kept members beside parallel ones and
    a cluster without members; ``ties``: clusters of 3-40 members (so a
    lane of the kernel's warp scans two of a cluster's events or members)
    with parameters in {-1, ..., 3} and equally long segments; ``one_camera``: every member in view 2;
    ``many_views``: 40 views, clusters of 33-40 members in distinct views;
    ``large``: clusters of 129, 300 and 1000 members (past
    ``sweep.SMEM_MEMBERS``) beside small ones; ``empty``: 3 clusters, no
    member; ``no_clusters``: neither."""
    rng = np.random.default_rng(seed)
    V = 40 if name == "many_views" else 6
    cam_x = rng.integers(-5, 6, V)
    cam_z = rng.integers(-3, 4, V)
    members = []                     # (cluster, view, kind, t1, t2)
    lines = []                       # (exact, zc or (P, D))

    def cluster(sizes_kinds, views=None, t_range=(-6, 8)):
        c = len(lines)
        exact = all(k != "random" for k in sizes_kinds)
        if exact:
            lines.append((True, int(rng.integers(-3, 4))))
        else:
            D = rng.normal(size=3)
            lines.append((False, (rng.normal(size=3) * 5,
                                  D / np.linalg.norm(D))))
        for i, kind in enumerate(sizes_kinds):
            v = int(views[i]) if views is not None else int(rng.integers(V))
            t1, t2 = (float(x) for x in rng.integers(*t_range, size=2))
            members.append((c, v, kind, t1, t2))

    def mixed(n, p_parallel=0.1, exact=True, **kw):
        kinds = ["parallel" if rng.uniform() < p_parallel else
                 ("exact" if exact else "random") for _ in range(n)]
        cluster(kinds, **kw)

    if name == "random":
        for _ in range(60):
            mixed(int(rng.integers(0, 15)), exact=bool(rng.uniform() < 0.5))
    elif name == "sizes":
        for kept in (0, 1, 2, 3, 4, 3):
            kinds = ["exact"] * kept + ["parallel"] * int(rng.integers(0, 3))
            cluster(list(rng.permutation(kinds)) if kinds else [])
        cluster([])
    elif name == "ties":
        for _ in range(20):
            mixed(int(rng.integers(3, 41)), p_parallel=0.0,
                  t_range=(-1, 4))
    elif name == "one_camera":
        for _ in range(20):
            n = int(rng.integers(3, 12))
            mixed(n, exact=bool(rng.uniform() < 0.5), views=[2] * n)
    elif name == "many_views":
        for _ in range(12):
            n = int(rng.integers(33, 41))
            mixed(n, exact=bool(rng.uniform() < 0.5),
                  views=rng.permutation(V)[:n])
    elif name == "large":
        for n in (129, 5, 300, 128, 1000, 7):
            mixed(n, exact=n != 300, t_range=(-20, 21))
    elif name not in ("empty", "no_clusters"):
        raise ValueError(name)
    C = {"empty": 3, "no_clusters": 0}.get(name, len(lines))

    order = rng.permutation(len(members))          # clusters interleaved
    members = [members[i] for i in order]
    per_view = np.zeros(V, np.int64)
    ms = []
    for _, v, *_ in members:
        ms.append(per_view[v])
        per_view[v] += 1
    S = int(per_view.max(initial=0)) + 2
    r1 = rng.normal(size=(V, S, 3)).astype(np.float32)
    r2 = rng.normal(size=(V, S, 3)).astype(np.float32)
    segs = rng.uniform(0, 3000, (V, S, 4)).astype(np.float32)
    cam_C = np.stack([cam_x, -np.ones(V), cam_z], 1).astype(np.float32)
    line_P1 = np.zeros((C, 3))
    line_dir = np.zeros((C, 3))
    for c, (exact, geo) in enumerate(lines[:C]):
        if exact:
            line_P1[c] = (0.0, 0.0, geo)
            line_dir[c] = (1.0, 0.0, 0.0)
        else:
            line_P1[c], line_dir[c] = geo
    exact_t = np.full((len(members), 2), np.nan)
    for i, ((c, v, kind, t1, t2), s) in enumerate(zip(members, ms)):
        C_v = cam_C[v].astype(np.float64)
        if kind == "random":
            u = rng.uniform(-3, 5, 2)
            for r, uu in ((r1, u[0]), (r2, u[1])):
                q = line_P1[c] + uu * line_dir[c] + rng.normal(0, 0.01, 3)
                r[v, s] = (q - C_v) * rng.uniform(0.5, 2)
        else:
            dz = line_P1[c, 2] - C_v[2]
            r1[v, s] = (t1 - C_v[0], 1.0, dz)
            r2[v, s] = (t2 - C_v[0], 1.0, dz)
            exact_t[i] = (t1, t2)
            if kind == "parallel":
                r1[v, s] = line_dir[c]
                exact_t[i] = np.nan
        if name == "ties" and rng.uniform() < 0.5:
            x, y = rng.uniform(0, 2000, 2)
            segs[v, s] = (x, y, x + 3000, y + 4000)    # all 5000 long
    mc = np.array([m[0] for m in members], np.int32)
    mv = np.array([m[1] for m in members], np.int32)
    return dict(r1=r1, r2=r2, segs=segs, cam_C=cam_C, line_P1=line_P1,
                line_dir=line_dir, mc=mc, mv=mv,
                ms=np.array(ms, np.int32), C=C, exact=exact_t)


def sweep_arguments(case: dict, visibility: int, dev="cpu") -> tuple:
    """``sweep.sweep_clusters``' positional arguments for a
    :func:`sweep_case`, the tables as tensors on ``dev``."""
    t = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    return (t(case["r1"]), t(case["r2"]), t(case["segs"]), case["cam_C"],
            case["line_P1"], case["line_dir"], case["mc"], case["mv"],
            case["ms"], case["C"], visibility)


def test_sweep_cases_project_as_built():
    """Every member of an exact cluster projects to the parameters it was
    built for, bit for bit, a parallel member is not kept, and the large
    case has clusters past the kernel's shared-memory slice."""
    from line3dpp_tpu_torch.ops import fitting, sweep

    for name in SWEEP_CASES:
        case = sweep_case(name)
        mc, mv, ms = case["mc"], case["mv"], case["ms"]
        s1, s2, ok = fitting.project_members_onto_lines_np(
            case["line_P1"][mc], case["line_dir"][mc], case["cam_C"][mv],
            case["r1"][mv, ms], case["r2"][mv, ms])
        exact = ~np.isnan(case["exact"][:, 0])
        np.testing.assert_array_equal(s1[exact], case["exact"][exact, 0])
        np.testing.assert_array_equal(s2[exact], case["exact"][exact, 1])
        assert ok[exact].all()
        built_exact = np.array([case["line_dir"][c, 0] == 1.0 for c in mc],
                               bool)
        assert not ok[built_exact & ~exact].any(), name    # the parallel
        if name == "large":
            assert (np.bincount(mc) > sweep.SMEM_MEMBERS).sum() == 3
