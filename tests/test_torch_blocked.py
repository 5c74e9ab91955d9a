"""The blocked large-scene path and the all-matches mode (knn <= 0) of the
port against the JAX package on the CPU.

* ``_match_score_filter`` over a block of source rows that does not start
  at 0 and whose pairs reach views outside it, against JAX's: masks and
  target indices equal, scores and estimates within
  ``tests/test_torch_step.py``'s tolerances (the epipolar parameters round
  differently from XLA's).
* ``affinity_edges_flat`` against JAX's on the same edge list and the same
  estimates: the validity equal, the weights within 5e-3 as
  ``test_torch_step.py`` holds the dense ones (the point-to-line distances
  cancel in |w|^2 - proj^2, which XLA evaluates in another order; measured
  1.3e-3 here), and against the port's ``affinity_dense`` bit for bit.
* ``Line3D`` with ``view_block=4`` on ``tests/test_blocked.py``'s 9-view
  scene against JAX's blocked run (the same line count, segments within
  1e-3, as ``test_blocked.py`` holds JAX's blocked against its fused run)
  and the port's own fused run (the same count, the same bits); also with
  RDD and collinearity, and with ``match_rel_cut`` and
  ``cluster_strong_min``, which the blocked path bypasses as JAX's does.
* ``knn=-1``, ``knn=0`` and ``knn=20`` on ``tests/test_config_modes.py``'s
  scene against JAX; the plain matcher at k = S keeps every valid match of
  the numpy reference matcher, and its first 10 slots are its k = 10
  output.
* The auto-blocking rule and its printed line, on sizes that would not fit
  (no large array is built).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu.models import step as jax_step
from line3dpp_tpu.ops import affinity as jax_affinity
from line3dpp_tpu_torch.models import step
from line3dpp_tpu_torch.models.pipeline import STEP_ARRAYS
from line3dpp_tpu_torch.ops import affinity, matching

import test_blocked
import test_config_modes
from test_matching import make_scene, np_match_pair

BASE = dict(num_neighbors=4, max_line_segments=64, optimize=False)
MSF_KW = dict(epipolar_overlap=0.25, knn=4, two_sig_a_sqr=200.0,
              min_similarity=0.5, check_orientation=True,
              min_best_score=0.75, min_best_score_perc=0.10, pair_chunk=4)


def _blocked_scene_views():
    """``test_blocked.py``'s 9 views with their junk segments."""
    cams, P, Q = test_blocked._scene(np.random.default_rng(0))
    rng = np.random.default_rng(7)
    views = []
    for cam in cams:
        segs = np.hstack([cam.project(P), cam.project(Q)])
        junk = rng.uniform([0, 0, 0, 0], [1920, 1080, 1920, 1080],
                           size=(4, 4))
        views.append((cam, np.vstack([segs, junk])))
    return views


def _lines(pkg, cfg, views, **kw):
    pipe = pkg.Line3D(cfg, **kw)
    for i, (cam, segs) in enumerate(views):
        pipe.add_view(i, cam, segs)
    pipe.match_images()
    return pipe.reconstruct_3d_lines()


def _canonical(lines) -> np.ndarray:
    """Every 3D segment with its endpoints in lexicographic order, the rows
    sorted: a line set as an array that does not depend on the order."""
    x = np.concatenate([l.segments3d for l in lines]).astype(np.float64)
    a, b = x[:, :3], x[:, 3:]
    first = (a[:, 0] < b[:, 0]) | ((a[:, 0] == b[:, 0]) & (
        (a[:, 1] < b[:, 1]) | ((a[:, 1] == b[:, 1]) & (a[:, 2] <= b[:, 2]))))
    x = np.where(first[:, None], x, np.concatenate([b, a], 1))
    return x[np.lexsort(x.T[::-1])]


def _port_inputs(views, **cfg_kw):
    pipe = lt.Line3D(lt.Config(**BASE, **cfg_kw), device="cpu")
    for i, (cam, segs) in enumerate(views):
        pipe.add_view(i, cam, segs)
    return pipe.step_inputs()


def test_match_score_filter_block_against_jax():
    """Rows 4..7 of 9: their targets include views 0..3 and 8."""
    inp = _port_inputs(_blocked_scene_views())
    lo, hi = 4, 8
    nbr = inp["neighbor_ids"][lo:hi]
    assert (nbr < lo).any() and (nbr >= hi).any()
    rows = np.arange(lo, hi, dtype=np.int32)
    whole = [inp[n] for n in STEP_ARRAYS[:5]]
    block = [inp[n][lo:hi] for n in STEP_ARRAYS[5:]]
    got = step._match_score_filter(
        *(torch.from_numpy(a) for a in whole + block),
        src_rows=torch.from_numpy(rows), **MSF_KW)
    want = jax_step._match_score_filter(
        *(jnp.asarray(a) for a in whole + block), src_rows=jnp.asarray(rows),
        use_pallas_matching=False, use_pallas_scoring=False, **MSF_KW)
    g = lambda d, n: np.asarray(d[n])
    mv = g(want, "t_valid")
    assert mv.sum() > 200
    np.testing.assert_array_equal(g(got, "t_valid"), mv)
    np.testing.assert_array_equal(g(got, "t_seg")[mv], g(want, "t_seg")[mv])
    np.testing.assert_array_equal(got["scored"].valid.numpy(),
                                  np.asarray(want["scored"].valid))
    np.testing.assert_allclose(got["scored"].score3d.numpy(),
                               np.asarray(want["scored"].score3d), atol=5e-3)
    fm, wfm = got["fm"], want["fm"]
    for n in ("kept", "est_valid"):
        np.testing.assert_array_equal(getattr(fm, n).numpy(),
                                      np.asarray(getattr(wfm, n)), n)
    assert wfm.est_valid.sum() > 20
    for n in ("est_P1", "est_P2", "est_d1", "est_d2"):
        np.testing.assert_allclose(getattr(fm, n).numpy(),
                                   np.asarray(getattr(wfm, n)), rtol=1e-3,
                                   atol=1e-4, err_msg=n)
    np.testing.assert_allclose(got["median_depth"].numpy(),
                               np.asarray(want["median_depth"]), rtol=1e-3)


def test_forward_step_is_match_score_filter_over_every_row():
    """The fused step's matching, scoring and filtering are
    ``_match_score_filter`` with every row, bit for bit."""
    inp = _port_inputs(_blocked_scene_views())
    args = [torch.from_numpy(inp[n]) for n in STEP_ARRAYS]
    out = step.forward_step(*args, **MSF_KW)
    msf = step._match_score_filter(*args, **MSF_KW)
    assert torch.equal(out.tgt_seg, msf["t_seg"])
    assert torch.equal(out.score3d, msf["scored"].score3d)
    assert torch.equal(out.est_P1, msf["fm"].est_P1)
    assert torch.equal(out.median_depth, msf["median_depth"])


def _edge_case():
    """The fused step on the 9-view scene and its kept matches as a flat
    edge list (source view and segment, target view and segment)."""
    inp = _port_inputs(_blocked_scene_views())
    args = [torch.from_numpy(inp[n]) for n in STEP_ARRAYS]
    out = step.forward_step(*args, **MSF_KW)
    V, S, M = out.tgt_seg.shape
    knn = MSF_KW["knn"]
    idx = torch.nonzero(out.kept.reshape(-1)).reshape(-1).numpy()
    sv, ss, slot = idx // (S * M), (idx // M) % S, idx % M
    tv = inp["neighbor_ids"][sv, slot // knn].astype(np.int64)
    ts = out.tgt_seg.reshape(-1)[idx].numpy().astype(np.int64)
    meds = np.sort(out.median_depth.numpy()[out.median_depth.numpy() > 1e-12])
    return inp, out, idx, (sv, ss, tv, ts), float(meds[len(meds) // 2])


def test_affinity_edges_flat_against_dense_and_jax():
    inp, out, idx, edges, med_scene = _edge_case()
    assert len(idx) > 100
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    est = [out.est_P1, out.est_P2, out.est_d1, out.est_d2, out.est_valid]
    ok = torch.ones(len(idx), dtype=torch.bool)
    w, valid = affinity.affinity_edges_flat(
        *est, *(t(e) for e in edges), ok, t(inp["k_reg"]),
        out.median_depth, med_scene, 200.0, 0.5)
    # the dense form on the same estimates, at the same edges
    np.testing.assert_array_equal(valid.numpy(),
                                  out.aff_valid.reshape(-1)[idx].numpy())
    assert valid.sum() > 50
    assert torch.equal(w, out.aff_weight.reshape(-1)[idx])
    jw, jvalid = jax_affinity.affinity_edges_flat(
        *(jnp.asarray(x.numpy()) for x in est),
        *(jnp.asarray(e.astype(np.int32)) for e in edges),
        jnp.ones(len(idx), bool), jnp.asarray(inp["k_reg"]),
        jnp.asarray(out.median_depth.numpy()), med_scene, 200.0, 0.5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=5e-3)


def test_compact_kept_is_row_major():
    rng = np.random.default_rng(4)
    kept = torch.from_numpy(rng.uniform(size=(3, 5, 6)) < 0.3)
    tgt = torch.from_numpy(rng.integers(0, 9, (3, 5, 6)).astype(np.int32))
    idx, ts = affinity.compact_kept(kept, tgt)
    want = np.flatnonzero(kept.numpy())
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(ts, tgt.numpy().reshape(-1)[want])


@pytest.mark.parametrize("opts", [
    dict(),
    dict(perform_rdd=True, collinearity_t=2.0),
    dict(match_rel_cut=0.5, cluster_strong_min=3.0),
], ids=["plain", "rdd_collinearity", "rel_cut_anchored"])
def test_blocked_pipeline_against_jax(opts):
    views = _blocked_scene_views()
    got = _lines(lt, lt.Config(**BASE, view_block=4, **opts), views,
                 device="cpu")
    want = _lines(l3d, l3d.Config(**BASE, view_block=4, **opts), views)
    assert len(want) > 0 and len(got) == len(want)
    np.testing.assert_allclose(_canonical(got), _canonical(want), rtol=1e-3,
                               atol=1e-3)


def test_blocked_equals_fused_in_the_port():
    """The port's blocked run gives its fused run's lines bit for bit on
    this scene: the blocks run the same per-row arithmetic, and the flat
    affinity the dense one's expressions."""
    views = _blocked_scene_views()
    fused = _lines(lt, lt.Config(**BASE), views, device="cpu")
    for vb in (4, 5):
        blocked = _lines(lt, lt.Config(**BASE, view_block=vb), views,
                         device="cpu")
        assert len(blocked) == len(fused) > 0
        for a, b in zip(blocked, fused):
            np.testing.assert_array_equal(a.segments3d, b.segments3d)


def _modes_views():
    cams, P, Q = test_config_modes._scene(np.random.default_rng(0))
    return [(cam, np.hstack([cam.project(P), cam.project(Q)]))
            for cam in cams]


@pytest.mark.parametrize("knn", [-1, 0, 20])
def test_knn_modes_against_jax(knn):
    views = _modes_views()
    got = _lines(lt, lt.Config(**BASE, knn=knn), views, device="cpu")
    want = _lines(l3d, l3d.Config(**BASE, knn=knn), views)
    assert len(want) >= 8 and len(got) == len(want)
    np.testing.assert_allclose(_canonical(got), _canonical(want), rtol=1e-3,
                               atol=1e-3)


def _pair_tables(cam1, cam2, segs1, segs2, S=64):
    segs = np.zeros((2, S, 4), np.float32)
    mask = np.zeros((2, S), bool)
    for i, s in enumerate((segs1, segs2)):
        segs[i, :len(s)] = s
        mask[i, :len(s)] = True
    F = lt.fundamental_matrix(cam1, cam2).astype(np.float32)[None]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return matching.pair_tables(
        t(segs), t(mask),
        t(np.stack([cam1.RtKinv, cam2.RtKinv]).astype(np.float32)),
        t(np.stack([cam1.C, cam2.C]).astype(np.float32)),
        t(np.array([0], np.int32)), t(np.array([1], np.int32)), t(F),
        t(np.array([True])))


def test_all_matches_keep_every_valid_match(rng):
    """With k = S the plain matcher holds every valid match of the numpy
    reference matcher (line3D.cc:973-988 pushes every candidate when
    kNN <= 0), as ``test_config_modes.py`` holds JAX's."""
    cam1, cam2, segs1, segs2 = make_scene(rng)
    S = 64
    ref = np_match_pair(cam1, cam2, segs1, segs2, 0.25, -1)
    res = matching.match_pairs_plain(_pair_tables(cam1, cam2, segs1, segs2),
                                     0.25, S)
    tgt, valid = res.tgt_seg[0].numpy(), res.valid[0].numpy()
    got = {(r, int(tgt[r, j])) for r in range(S) for j in range(S)
           if valid[r, j]}
    want = {(r, c) for r, cand in ref.items() for (_, c, *rest) in cand}
    assert want and want == got


def test_all_matches_prefix_is_top_k(rng):
    """The plain matcher's first 10 slots at k = S are its k = 10 output."""
    cam1, cam2, segs1, segs2 = make_scene(rng, n_lines=60)
    t = _pair_tables(cam1, cam2, segs1, segs2)
    every = matching.match_pairs_plain(t, 0.25, 64)
    top = matching.match_pairs_plain(t, 0.25, 10)
    assert int((every.valid.sum(-1) > 10).sum()) > 0
    for name in top._fields:
        assert torch.equal(getattr(every, name)[..., :10],
                           getattr(top, name)), name


def _jax_rule(V, S, N, k, view_block):
    """``line3dpp_tpu.models.pipeline.Line3D.match_images``'s rule and
    line, written out (it is inline there)."""
    fused_bytes = V * S * N * k * 4
    line = None
    if view_block <= 0 and fused_bytes > (2 << 30):
        view_block = max(1, (2 << 30) // max(S * N * k * 4, 1))
        line = (f"[L3D-TPU] match tensors would be "
                f"{fused_bytes / (1 << 30):.1f} GiB per array (knn=%d); "
                f"auto-blocking source views at view_block={view_block}")
    return (view_block if view_block > 0 and V > view_block else 0), line


@pytest.mark.parametrize("V,S,N,k,knn,view_block", [
    (26, 3000, 16, 3000, 0, 0),        # all matches on the 26 views: 3
    (1200, 3000, 16, 10, 10, 0),       # past 2 GiB at k = 10
    (1000, 3000, 16, 10, 10, 0),       # fits: fused
    (104, 3000, 20, 10, 10, 26),       # a given view_block
    (20, 3000, 16, 10, 10, 26),        # V <= view_block: fused
    (4, 64, 4, 64, -1, 0),             # small all-matches: fused
])
def test_auto_blocking_rule_and_line(capsys, V, S, N, k, knn, view_block):
    pipe = lt.Line3D(lt.Config(knn=knn, view_block=view_block),
                     device="cpu")
    got = pipe._view_block(V, S, N, k)
    want, line = _jax_rule(V, S, N, k, view_block)
    assert got == want
    out = capsys.readouterr().out.strip()
    assert out == (line % knn if line else "")
    if (V, k) == (26, 3000):
        assert got == 3
