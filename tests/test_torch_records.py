"""The clustering records of ``Line3D`` (``_split_records``,
``_cluster_records``) and the ``L3D_SPLIT_DEBUG`` print, against the JAX
package's, on the CPU.

The scene: cached views 0-7 of ``testdata/L3D_cache`` at
``max_line_segments=600`` under the repository's compensations
(``split_bimodal_t=1.1, split_strong_min=3.0, cluster_strong_min=3.0,
match_rel_cut=0.5``, no bundling), where JAX records 241 emitted clusters,
117 dropped by visibility and 5 split candidates, none applied (so the
``applied`` flag is compared as False throughout; the pipeline tests of
``tests/test_torch_features.py`` cover applied splits).  The port's own
step gives 240 lines there (float32 order of the epipolar parameters,
ROADMAP section 3), so the port's ``reconstruct_3d_lines`` is handed JAX's
step outputs (``forward_step`` of the port's step inputs, checked equal to
JAX's pipeline state) and JAX's rays, converted to tensors on the CPU, in
place of its own in ``_last_state``: both host tails then start from the
same numbers.

Compared: the counts and node sets per outcome, the emitted records'
``line_idx``; for the split records ``n``, ``lvl``, ``applied`` and the
(view, segment) member sets of ``lo`` and ``hi`` equal, ``delta`` and
``D`` within rtol 1e-9 (float64 numpy in both); the printed counters equal.
In the port alone: recording changes no line, the emitted records are the
lines, and no node lies in two cluster records.
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu.models import step as jax_step
from line3dpp_tpu.ops import geometry as jax_geo
from line3dpp_tpu_torch.models.pipeline import STEP_ARRAYS
from line3dpp_tpu_torch.models.step import StepOutputs
from line3dpp_tpu_torch.utils.testdata import load_views

OPTIONS = dict(optimize=False, split_bimodal_t=1.1, split_strong_min=3.0,
               cluster_strong_min=3.0, match_rel_cut=0.5,
               max_line_segments=600)
VIEWS = range(8)
RTOL = 1e-9
OUTCOMES = ("emitted", "tiny", "sweep-empty", "visibility")


def _reconstruct(pipe):
    """Lines and the records of one ``reconstruct_3d_lines`` with both
    lists on; the lists are off again afterwards."""
    pipe._split_records, pipe._cluster_records = [], []
    lines = pipe.reconstruct_3d_lines()
    rec = dict(split=pipe._split_records, cluster=pipe._cluster_records)
    pipe._split_records = pipe._cluster_records = None
    return lines, rec


def _jax_steps(pipe):
    """JAX's step outputs and rays for the port's step inputs, as the
    port's types on the CPU."""
    inp = pipe.step_inputs()
    out = jax_step.forward_step(
        *(jnp.asarray(inp[n]) for n in STEP_ARRAYS), knn=inp["knn"],
        min_affinity=pipe.config.min_affinity, **pipe._step_options())
    out = StepOutputs(*(torch.from_numpy(np.array(x)) for x in out))
    rays = jax_geo.segment_rays(jnp.asarray(inp["RtKinv"])[:, None],
                                jnp.asarray(inp["segments"]))
    return out, [torch.from_numpy(np.array(r)) for r in rays]


@pytest.fixture(scope="module")
def scene():
    views = load_views(VIEWS)
    jp = l3d.Line3D(l3d.Config(**OPTIONS))
    tp = lt.Line3D(lt.Config(**OPTIONS), device="cpu")
    for v in views:
        jp.add_view(v.cam_id, l3d.Camera(v.K, v.R, v.t, v.width, v.height),
                    v.segments)
        tp.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                    v.segments)
    jp.match_images()
    tp.match_images()
    out, (r1, r2) = _jax_steps(tp)
    for name in ("score3d", "aff_weight", "aff_valid"):
        want = jp._last_state["score3d"] if name == "score3d" else getattr(
            jp._last_state["aff"], {"aff_weight": "weight",
                                    "aff_valid": "edge_valid"}[name])
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(want), name)
    tp._last_state.update(out=out, est=out, median_depth=out.median_depth,
                          r1=r1, r2=r2)
    jl, jrec = _reconstruct(jp)
    tl, trec = _reconstruct(tp)
    return dict(jax=(jp, jl, jrec), port=(tp, tl, trec))


def _by_outcome(records):
    out = {k: [] for k in OUTCOMES}
    for r in records:
        out[r["outcome"]].append(r)
    return out


def _node_sets(records):
    return sorted(tuple(sorted(int(n) for n in r["nodes"])) for r in records)


def test_cluster_outcome_counts_match_jax(scene):
    (_, jl, jrec), (_, tl, trec) = scene["jax"], scene["port"]
    want = Counter(r["outcome"] for r in jrec["cluster"])
    assert Counter(r["outcome"] for r in trec["cluster"]) == want
    assert want["emitted"] == len(jl) == len(tl) > 0
    assert want["visibility"] > 0


@pytest.mark.parametrize("outcome", OUTCOMES)
def test_cluster_node_sets_match_jax(scene, outcome):
    got = _by_outcome(scene["port"][2]["cluster"])[outcome]
    want = _by_outcome(scene["jax"][2]["cluster"])[outcome]
    assert _node_sets(got) == _node_sets(want)
    if outcome != "visibility":
        key = lambda r: tuple(sorted(int(n) for n in r["nodes"]))
        assert ({key(r): r["line_idx"] for r in got}
                == {key(r): r["line_idx"] for r in want})


def _members(side):
    views, segs = side
    return sorted(zip(views.tolist(), segs.tolist()))


def test_split_records_match_jax(scene):
    got, want = scene["port"][2]["split"], scene["jax"][2]["split"]
    assert len(got) == len(want) > 0
    key = lambda r: (r["lvl"], r["n"], tuple(_members(r["lo"]) +
                                             _members(r["hi"])))
    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert set(g) == set(w)
        for k in ("n", "lvl", "applied"):
            assert g[k] == w[k], k
        # the principal axis's free sign may swap the two sides
        sides = {tuple(_members(g["lo"])), tuple(_members(g["hi"]))}
        assert sides == {tuple(_members(w["lo"])), tuple(_members(w["hi"]))}
        np.testing.assert_allclose([g["delta"], g["D"]],
                                   [w["delta"], w["D"]], rtol=RTOL)
        assert g["delta"] >= 0.5


def test_split_debug_print_matches_jax(scene, monkeypatch, capsys):
    monkeypatch.setenv("L3D_SPLIT_DEBUG", "1")
    printed = []
    for pkg in ("jax", "port"):
        scene[pkg][0].reconstruct_3d_lines()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0].count("[L3D-TPU] bimodal split: {") == 1
    monkeypatch.delenv("L3D_SPLIT_DEBUG")
    scene["port"][0].reconstruct_3d_lines()
    assert capsys.readouterr().out == ""


def test_recording_changes_no_line(scene):
    pipe, with_records, _ = scene["port"]
    assert pipe._split_records is None and pipe._cluster_records is None
    without = pipe.reconstruct_3d_lines()
    assert len(without) == len(with_records)
    for a, b in zip(without, with_records):
        np.testing.assert_array_equal(a.segments3d, b.segments3d)
        np.testing.assert_array_equal(a.residuals, b.residuals)


def test_emitted_records_are_the_lines(scene):
    pipe, lines, rec = scene["port"]
    S = pipe._last_state["mask"].shape[1]
    cam_ids = pipe._last_state["cam_ids"]
    emitted = _by_outcome(rec["cluster"])["emitted"]
    assert sorted(r["line_idx"] for r in emitted) == list(range(len(lines)))
    for r in emitted:
        res = lines[r["line_idx"]].residuals
        assert sorted((cam_ids[n // S], n % S) for n in r["nodes"]) == \
            sorted(zip(res[:, 0].astype(int).tolist(),
                       res[:, 1].astype(int).tolist()))
    nodes = np.concatenate([r["nodes"] for r in rec["cluster"]])
    assert len(np.unique(nodes)) == len(nodes)
