"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py), and
tests of those inputs.

Every scene is made with numpy from a seed (or read from the bundled
testdata) and handed to both packages as numpy arrays.
"""

from __future__ import annotations

import numpy as np

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


def pair_list(inp: dict):
    """(src_idx, tgt_idx, F, pair_valid) flattened over (view, slot)."""
    V, N = inp["neighbor_ids"].shape
    src = np.repeat(np.arange(V, dtype=np.int32), N)
    return (src, inp["neighbor_ids"].reshape(-1),
            inp["F"].reshape(-1, 3, 3), inp["pair_valid"].reshape(-1))


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
