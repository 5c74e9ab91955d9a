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
