"""The optional reconstruction stages of the port against the JAX
package's, on the CPU: the relative score cut (``match_rel_cut``),
collinearity edges (``collinearity_t``), replicator-dynamics diffusion
(``perform_rdd``), anchored clustering (``cluster_strong_min``) and the
bimodal split (``split_bimodal_t``, ``split_strong_min``), each function on
seeded inputs and the pipeline with each option and all of them composed.

Tolerances: the collinear pairs and the rel-cut mask are bit-equal (the
same float32 expressions in the same order); the collinear similarity
within rtol 1e-5 (``exp`` may round differently in the last bit); RDD
within rtol 1e-4 of JAX's sparse path and of the dense form (float32 sums
of the sampled product in another order); the clusterings are the same
partitions; the split gives the same partition and refitted lines within
1e-9 (float64 numpy in both, the principal axis's sign free).  Pipelines:
JAX's own ground-truth bounds (recall and precision > 0.9 at 0.05) and the
port's lines against JAX's at count_f1 >= 0.99 (1% scene scale), with the
line counts equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu.camera import rotation_from_rpy
from line3dpp_tpu.models.pipeline import _rel_cut_mask
from line3dpp_tpu.ops import clustering as jclust
from line3dpp_tpu.ops import collinearity as jcollin
from line3dpp_tpu.ops import rdd as jrdd
from line3dpp_tpu_torch.ops import affinity, clustering, collinearity, rdd
from line3dpp_tpu_torch.utils import golden

from tests.test_clustering import _random_edges
from tests.test_torch_scenes import broken_line_views as _broken_line_views
from tests.test_torch_scenes import similarity_inputs as _similarity_inputs
from tests.test_split_bimodal import _make_cluster


def _same_partition(a, b):
    _, a = np.unique(a, return_inverse=True)
    _, b = np.unique(b, return_inverse=True)
    np.testing.assert_array_equal(a[:, None] == a[None, :],
                                  b[:, None] == b[None, :])


# ---------------------------------------------------------------- collinear
def test_collinear_pairs_hand_built():
    segs = np.array([[[10.0, 50.0, 100.0, 50.0], [150.0, 50.0, 250.0, 50.0],
                      [40.0, 50.0, 160.0, 50.0], [10.0, 80.0, 100.0, 80.0],
                      [50.0, 10.0, 50.0, 120.0]]], np.float32)
    mask = np.ones((1, 5), bool)
    want = np.asarray(jcollin.collinear_pairs(jnp.asarray(segs),
                                              jnp.asarray(mask), 2.0))
    got = collinearity.collinear_pairs(torch.from_numpy(segs),
                                       torch.from_numpy(mask), 2.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 1] and not got[0, 0, 2]


@pytest.mark.parametrize("t_px", [1.0, 2.0, 4.0])
def test_collinear_pairs_bit_equal(t_px):
    segs, mask = _broken_line_views(np.random.default_rng(3))
    want = np.asarray(jcollin.collinear_pairs(jnp.asarray(segs),
                                              jnp.asarray(mask), t_px))
    got = collinearity.collinear_pairs(torch.from_numpy(segs),
                                       torch.from_numpy(mask), t_px).numpy()
    assert want.sum() > 20
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("med_scene", [0.0, 7.5])
def test_collinear_similarity(med_scene):
    args = _similarity_inputs(np.random.default_rng(5))
    jw, je = jcollin.collinear_similarity(
        *(jnp.asarray(a) for a in args[:6]), jnp.asarray(args[6]),
        jnp.asarray(args[7]), med_scene, 0.5)
    w, e = collinearity.collinear_similarity(
        *(torch.from_numpy(a) for a in args), med_scene, 0.5)
    jw, je = np.asarray(jw), np.asarray(je)
    assert je.sum() > 100
    np.testing.assert_array_equal(e.numpy(), je)
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-5, atol=0)


def test_collinear_edges_compacts_the_upper_triangle(monkeypatch):
    """Batched over views and compacted on the device, the edges are the
    JAX pipeline's ``np.nonzero`` of the dense grid, ``s1 < s2``, with 1, 2
    and 3 views a batch (``_BATCH_BYTES`` sized to hold that many)."""
    rng = np.random.default_rng(5)
    P1, P2, d1, d2, valid, _, k_reg, med = _similarity_inputs(rng)
    segs, mask = _broken_line_views(rng, V=3, S=120)
    jc = jcollin.collinear_pairs(jnp.asarray(segs), jnp.asarray(mask), 2.0)
    jw, je = jcollin.collinear_similarity(
        *(jnp.asarray(a) for a in (P1, P2, d1, d2, valid)), jc,
        jnp.asarray(k_reg), jnp.asarray(med), 7.5, 0.5)
    cv, c1, c2 = np.nonzero(np.asarray(je))
    keep = c1 < c2
    t = lambda a: torch.from_numpy(a)              # noqa: E731
    S = segs.shape[1]
    for batch in (1, 2, 3):
        monkeypatch.setattr(collinearity, "_BATCH_BYTES",
                            batch * collinearity._PLANES * 4 * S * S)
        got = collinearity.collinear_edges(
            t(segs), t(mask), t(P1), t(P2), t(d1), t(d2), t(valid),
            t(k_reg), t(med), 7.5, 2.0, 0.5)
        assert len(got[0]) == keep.sum() > 0
        for g, w in zip(got[:3], (cv[keep], c1[keep], c2[keep])):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(got[3], np.asarray(jw)[cv, c1, c2][keep],
                                   rtol=1e-5)


@pytest.mark.parametrize("V,S", [(0, 5), (3, 0)])
def test_collinear_edges_no_views_and_no_segments(V, S):
    """No views or no segments: no edges, with the dtypes of a result that
    has some."""
    z = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
        shape, dtype=dtype)
    got = collinearity.collinear_edges(
        z(V, S, 4), z(V, S, dtype=torch.bool), z(V, S, 3), z(V, S, 3),
        z(V, S), z(V, S), z(V, S, dtype=torch.bool), z(V), z(V), 0.0, 2.0,
        0.5)
    assert [len(g) for g in got] == [0] * 4
    assert [g.dtype for g in got] == [np.dtype(np.int64)] * 3 + [
        np.dtype(np.float32)]


# ---------------------------------------------------------------------- RDD
def _random_graph(rng):
    N = int(rng.integers(20, 200))
    E = int(rng.integers(N, N * 5))
    ei = rng.integers(0, N, E)
    ej = rng.integers(0, N, E)
    keep = ei != ej
    lo = np.minimum(ei, ej)[keep]
    hi = np.maximum(ei, ej)[keep]
    _, first = np.unique(lo * N + hi, return_index=True)
    return N, lo[first], hi[first], rng.uniform(0.5, 1.0, len(first)).astype(
        np.float32)


def _cliques():
    W = np.zeros((8, 8), np.float32)
    for block in (range(0, 4), range(4, 8)):
        for i in block:
            for j in block:
                if i != j:
                    W[i, j] = 0.9
    W[3, 4] = W[4, 3] = 0.6
    ei, ej = np.nonzero(W)                 # both directions
    return 8, ei.astype(np.int32), ej.astype(np.int32), W[ei, ej]


@pytest.mark.parametrize("case", ["cliques", "random0", "random1",
                                  "random2"])
def test_rdd_matches_jax(case):
    if case == "cliques":
        N, ei, ej, ew = _cliques()
    else:
        rng = np.random.default_rng(int(case[-1]))
        N, ei, ej, ew = _random_graph(rng)
    want = jrdd.rdd_edges(ei, ej, ew, N, iterations=10)
    got = rdd.rdd_edges(ei, ej, ew, N, iterations=10, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    W = np.zeros((N, N), np.float32)
    W[ei, ej] = ew
    W[ej, ei] = ew
    dense_j = np.asarray(jrdd.rdd_dense(jnp.asarray(W), iterations=10))
    dense_t = rdd.rdd_dense(torch.from_numpy(W), iterations=10).numpy()
    np.testing.assert_allclose(dense_t, dense_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got, dense_t[ei, ej], rtol=1e-4, atol=1e-7)
    if case == "cliques":
        out = np.zeros_like(W)
        out[ei, ej] = got
        assert out[3, 4] < 0.2 * out[0, 1]
        np.testing.assert_array_equal(out, out.T)


def test_rdd_large_graph_memory():
    """``test_rdd.py``'s 50k nodes / 500k edges: finite, non-negative, a
    bounded wedge plan, well inside the time and memory of a tier-1 test
    (measured: 0.7 s and 0.58 GB of peak resident growth on the CPU)."""
    import resource

    rng = np.random.default_rng(7)
    N, E = 50_000, 500_000
    ei = rng.integers(0, N, E)
    ej = rng.integers(0, N, E)
    keep = ei != ej
    lo = np.minimum(ei, ej)[keep]
    hi = np.maximum(ei, ej)[keep]
    _, first = np.unique(lo.astype(np.int64) * N + hi, return_index=True)
    ei, ej = lo[first], hi[first]
    ew = rng.uniform(0.5, 1.0, len(ei)).astype(np.float32)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out = rdd.rdd_edges(ei, ej, ew, N, iterations=3, device="cpu")
    grow_gb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
               - rss0) / 2**20
    assert out.shape == ei.shape
    assert np.all(np.isfinite(out)) and np.all(out >= 0)
    assert grow_gb < 2.0, grow_gb
    csr = rdd.CSR(ei, ej, ew, N, torch.device("cpu"))
    a, b, lengths = rdd.wedge_plan(csr)
    assert int(lengths.sum()) == len(a) == len(b)
    # every wedge closes on an entry: (row of a, col of b) is in the pattern
    t = torch.repeat_interleave(torch.arange(len(lengths)), lengths)
    assert torch.equal(csr.row[a], csr.row[t])
    assert torch.equal(csr.col[b], csr.col[t])
    assert torch.equal(csr.col[a], csr.row[b])


def test_rdd_without_a_card_raises(monkeypatch):
    """``rdd_edges`` runs on the card unless the caller names the CPU: with
    no card and no device it raises, and it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    N, ei, ej, ew = _cliques()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rdd.rdd_edges(ei, ej, ew, N)
    assert rdd.rdd_edges(ei, ej, ew, N, device="cpu").shape == ew.shape


# --------------------------------------------------------------- clustering
def test_anchored_matches_jax_on_a_seeded_graph():
    rng = np.random.default_rng(0)
    i, j, w = _random_edges(rng)
    for frac in (0.0, 0.3, 0.7, 1.0):
        strong = rng.uniform(size=200) < frac
        _same_partition(
            clustering.cluster_edges_anchored(i, j, w, 200, strong, 3.0),
            jclust.cluster_edges_anchored(i, j, w, 200, strong, 3.0))


def _anchored_cases():
    bridge = []
    for base in (0, 3):
        for a in range(3):
            for b in range(a + 1, 3):
                bridge.append((base + a, base + b, 0.1))
    bridge += [(2, 6, 0.15), (6, 3, 0.15)]
    refine = [(0, 2, 0.1), (0, 3, 0.1), (1, 4, 0.1), (1, 5, 0.1),
              (0, 1, 0.9)]
    rng = np.random.default_rng(0)
    i, j, w = _random_edges(rng)
    return {
        "all_weak": (i, j, w, 200, np.zeros(200, bool), 3.0),
        "weak_bridge": (*(np.array(c, t) for c, t in zip(
            zip(*bridge), (np.int32, np.int32, np.float32))), 7,
            np.array([1, 1, 1, 1, 1, 1, 0], bool), 3.0),
        "pass2_refines": (*(np.array(c, t) for c, t in zip(
            zip(*refine), (np.int32, np.int32, np.float32))), 6,
            np.array([1, 1, 0, 0, 0, 0], bool), 1.0),
    }


@pytest.mark.parametrize("case", ["all_weak", "weak_bridge",
                                  "pass2_refines"])
def test_anchored_cases_match_jax(case):
    args = _anchored_cases()[case]
    got = clustering.cluster_edges_anchored(*args)
    _same_partition(got, jclust.cluster_edges_anchored(*args))
    if case == "weak_bridge":
        assert got[0] != got[3] and got[6] in (got[0], got[3])
    if case == "pass2_refines":
        assert got[0] != got[1]


# -------------------------------------------------------------------- split
@pytest.mark.parametrize("case", ["splits", "unimodal", "visibility",
                                  "strong_min"])
def test_split_bimodal_matches_jax(case):
    gap, hi_cams, m_score = 0.5, 4, None
    if case == "unimodal":
        gap = 0.02
    if case == "visibility":
        hi_cams = 2
    mc, mv, ms, P1, d, e1, e2, st, side = _make_cluster(gap, hi_cams)
    kw = dict(visibility=3, gap_t=1.5)
    if case == "strong_min":
        # the outer members of both sides are weak (score 1)
        m_score = np.where(np.arange(16) % 8 < 6, 4.0, 1.0)
        kw.update(m_score=m_score, strong_min=3.0)
    jpipe = l3d.Line3D(l3d.Config())
    tpipe = lt.Line3D(lt.Config(), device="cpu")
    want = jpipe._split_bimodal_clusters(mc, mv, ms, 1, P1.copy(), d.copy(),
                                         e1, e2, st, **kw)
    got = tpipe._split_bimodal_clusters(mc, mv, ms, 1, P1.copy(), d.copy(),
                                        e1, e2, st, **kw)
    assert got[1] == want[1]
    _same_partition(got[0], want[0])
    assert got[1] == (1 if case in ("unimodal", "visibility") else 2)
    # the same refitted line for each cluster, matched by its members
    for c in range(got[1]):
        cw = want[0][np.flatnonzero(got[0] == c)[0]]
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g[c], w[cw], atol=1e-9)


# ------------------------------------------------------------------ rel cut
def test_rel_cut_mask_bit_equal():
    rng = np.random.default_rng(2)
    shape = (4, 50, 12)
    score = rng.uniform(0, 5, shape).astype(np.float32)
    score[..., 3] = score[..., 2]              # ties at the cut's edge
    kept = rng.uniform(size=shape) > 0.3
    valid = kept & (rng.uniform(size=shape) > 0.2)
    weight = np.where(valid, rng.uniform(0.5, 1, shape), 0).astype(
        np.float32)
    for rel in (0.25, 0.5, 0.9):
        want = np.asarray(_rel_cut_mask(jnp.asarray(valid),
                                        jnp.asarray(score),
                                        jnp.asarray(kept), jnp.float32(rel)))
        got = affinity.rel_cut(
            affinity.AffinityDense(torch.from_numpy(weight),
                                   torch.from_numpy(valid)),
            torch.from_numpy(score), torch.from_numpy(kept), rel)
        np.testing.assert_array_equal(got.edge_valid.numpy(), want)
        np.testing.assert_array_equal(got.weight.numpy(),
                                      np.where(want, weight, 0))
        assert 0 < want.sum() < valid.sum()


# ---------------------------------------------------------------- pipelines
def _modes_scene():
    """tests/test_config_modes.py's scene (rng seed 0)."""
    rng = np.random.default_rng(0)
    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(10, 3))
    d = rng.normal(size=(10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.8, 1.6, size=(10, 1))
    poses = []
    for i in range(6):
        R = rotation_from_rpy(rng.normal() * 0.02, -0.05 * i + 0.12,
                              rng.normal() * 0.02)
        C = np.array([0.5 * i - 1.2, rng.normal() * 0.05,
                      rng.normal() * 0.05])
        poses.append((K, R, -R @ C, 1920, 1080))
    return poses, P, Q


def _features_scene():
    """tests/test_all_features.py's scene (rng seed 0)."""
    rng = np.random.default_rng(0)
    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(10, 3))
    d = rng.normal(size=(10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d
    poses = []
    for i in range(9):
        R = rotation_from_rpy(0, -0.04 * i + 0.15, 0)
        C = np.array([0.4 * i - 1.6, 0, 0])
        poses.append((K, R, -R @ C, 1920, 1080))
    return poses, P, Q


BASE = dict(num_neighbors=4, max_line_segments=64, optimize=False)
COMPENSATIONS = dict(split_bimodal_t=1.1, split_strong_min=3.0,
                     cluster_strong_min=3.0, match_rel_cut=0.5)
RUNS = {
    "rdd": ("modes", dict(BASE, perform_rdd=True)),
    "collinearity": ("modes", dict(BASE, collinearity_t=2.0)),
    "split": ("modes", dict(BASE, split_bimodal_t=1.1)),
    "split_strong": ("modes", dict(BASE, split_bimodal_t=1.1,
                                   split_strong_min=3.0)),
    "anchored": ("modes", dict(BASE, cluster_strong_min=3.0)),
    "rel_cut": ("modes", dict(BASE, match_rel_cut=0.5)),
    "all_composed": ("features", dict(
        BASE, optimize=True, collinearity_t=2.0, perform_rdd=True,
        **COMPENSATIONS)),
}


def _drive(pkg, kw, cfg, poses, P, Q):
    pipe = pkg.Line3D(pkg.Config(**cfg), **kw)
    for i, (K, R, t, W, H) in enumerate(poses):
        cam = pkg.Camera(K, R, t, W, H, median_depth=8.0)
        pipe.add_view(i, cam, np.hstack([cam.project(P), cam.project(Q)]))
    pipe.match_images()
    return [l.segments3d for l in pipe.reconstruct_3d_lines()]


@pytest.fixture(scope="module")
def runs():
    scenes = {"modes": _modes_scene(), "features": _features_scene()}
    out = {}
    for name, (scene, cfg) in RUNS.items():
        poses, P, Q = scenes[scene]
        out[name] = (_drive(lt, dict(device="cpu"), cfg, poses, P, Q),
                     _drive(l3d, {}, cfg, poses, P, Q), P, Q)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_pipeline_option_matches_jax(runs, name):
    port, ref, P, Q = runs[name]
    gt = np.hstack([P, Q])
    for lines in (port, ref):
        assert len(lines) >= 8
        m = golden.segment_set_metrics(np.concatenate(lines), gt, tol=0.05)
        assert m["recall"] > 0.9 and m["precision"] > 0.9, (name, m)
    assert len(port) == len(ref)
    tol = 0.01 * golden.scene_scale(np.concatenate(ref))
    assert golden.line_match_metrics(port, ref, tol)["count_f1"] >= 0.99


def test_collinear_halves_join_as_in_jax():
    """tests/test_collinearity.py's scene: two broken halves of one 3D line
    end up in one cluster in both packages."""
    out = []
    for pkg, kw in ((lt, dict(device="cpu")), (l3d, {})):
        rng = np.random.default_rng(0)
        K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
        P = np.array([[-1.5, 0.0, 8.0]])
        Q = np.array([[1.5, 0.0, 8.0]])
        mid1 = P + (Q - P) * 0.45
        mid2 = P + (Q - P) * 0.55
        extra_P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(6, 3))
        extra_d = rng.normal(size=(6, 3))
        extra_d /= np.linalg.norm(extra_d, axis=1, keepdims=True)
        extra_Q = extra_P + extra_d
        pipe = pkg.Line3D(pkg.Config(num_neighbors=4, max_line_segments=50,
                                     optimize=False, collinearity_t=2.0),
                          **kw)
        for i in range(5):
            R = rotation_from_rpy(rng.normal() * 0.02, -0.05 * i + 0.12,
                                  rng.normal() * 0.02)
            C = np.array([0.5 * i - 1.2, rng.normal() * 0.05,
                          rng.normal() * 0.05])
            cam = pkg.Camera(K, R, -R @ C, 1920, 1080)
            pipe.add_view(i, cam, np.vstack([
                np.hstack([cam.project(P), cam.project(mid1)]),
                np.hstack([cam.project(mid2), cam.project(Q)]),
                np.hstack([cam.project(extra_P), cam.project(extra_Q)])]))
        pipe.match_images()
        lines = pipe.reconstruct_3d_lines()
        out.append(sorted(sorted((int(r[0]), int(r[1])) for r in l.residuals)
                          for l in lines))
        assert any({0, 1} <= {int(r[1]) for r in l.residuals}
                   for l in lines)
    assert out[0] == out[1]


@pytest.mark.parametrize("kw", [dict(view_block=4), dict(knn=0),
                                dict(knn=-1)])
def test_only_the_blocked_options_raise(kw):
    """Item 14's options raised until the blocked path and the all-matches
    mode were ported (the name is kept); they now run, with item 13's
    options on, and recover the scene's lines (tests/test_torch_blocked.py
    holds them against JAX)."""
    from tests.test_config_modes import _scene

    cams, P, Q = _scene(np.random.default_rng(0))
    pipe = lt.Line3D(lt.Config(optimize=False, num_neighbors=4,
                               max_line_segments=64, perform_rdd=True,
                               collinearity_t=2.0, **kw), device="cpu")
    for i, c in enumerate(cams):
        pipe.add_view(i, lt.Camera(c.K, c.R, c.t, c.width, c.height),
                      np.hstack([c.project(P), c.project(Q)]))
    pipe.match_images()
    assert ("edges_flat" in pipe._last_state) == ("view_block" in kw)
    lines = pipe.reconstruct_3d_lines()
    assert len(lines) >= 8
    pred = np.concatenate([l.segments3d for l in lines])
    m = golden.segment_set_metrics(pred, np.hstack([P, Q]), tol=0.05)
    assert m["recall"] > 0.9, m
    lt.Line3D(lt.Config(perform_rdd=True, collinearity_t=2.0,
                        **COMPENSATIONS), device="cpu")
