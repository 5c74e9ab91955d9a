"""Host-side modules of the PyTorch port against the JAX package: config,
cameras, segment cache, writers, clustering, line fit, sweep; and the
port's import hygiene and its refusal of what it does not run yet.

These modules are numpy copies, so equal inputs must give equal outputs
bit for bit (bytes for the writers).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu import camera as jax_camera
from line3dpp_tpu.ops import clustering as jax_clustering
from line3dpp_tpu.ops import fitting as jax_fitting
from line3dpp_tpu.ops import sweep as jax_sweep
from line3dpp_tpu.utils import segments_cache as jax_cache
from line3dpp_tpu.utils import writers as jax_writers
from line3dpp_tpu_torch import camera
from line3dpp_tpu_torch.ops import clustering, fitting, sweep
from line3dpp_tpu_torch.utils import segments_cache, writers

from test_torch_scenes import SWEEP_CASES, sweep_arguments, sweep_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cameras(rng, V=5):
    out = []
    for _ in range(V):
        R = camera.rotation_from_rpy(*rng.normal(0, 0.3, 3))
        K = np.array([[1000 + 100 * rng.random(), 0.3, 640],
                      [0, 1000 + 100 * rng.random(), 480], [0, 0, 1]])
        out.append((K, R, rng.normal(0, 2, 3), 1280, 960))
    return out


def test_config_fields_defaults_and_tag_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(lt.Config)}
    ref = {f.name: f.default for f in dataclasses.fields(l3d.Config)}
    assert port == ref
    for kw in ({}, dict(optimize=False), dict(knn=0, seg_pad=500),
               dict(sigma_p=-1.0, perform_rdd=True, collinearity_t=2.0)):
        a, b = lt.Config(**kw), l3d.Config(**kw)
        assert a.filename_tag() == b.filename_tag()
        assert a.filename_tag(800) == b.filename_tag(800)
        for p in ("two_sig_a_sqr", "num_segments", "knn_effective",
                  "num_match_slots"):
            assert getattr(a, p) == getattr(b, p)


@pytest.mark.parametrize("sigma_p", [2.5, -0.05])
def test_camera_tables_match_jax(rng, sigma_p):
    specs = _cameras(rng)
    port = [camera.Camera(*s) for s in specs]
    ref = [jax_camera.Camera(*s) for s in specs]
    np.testing.assert_array_equal(camera.median_center_translation(port),
                                  jax_camera.median_center_translation(ref))
    kw = dict(sigma_p=sigma_p, translation=np.array([0.1, -0.2, 0.3]),
              med_scene_depth=4.0, fixed_3d_regularizer=sigma_p < 0)
    a = camera.CameraBatch.from_cameras(port, **kw)
    b = jax_camera.CameraBatch.from_cameras(ref, **kw)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name), f.name)
    src = np.array([0, 1, 2, 4, 3])
    tgt = np.array([1, 0, 4, 2, 0])
    np.testing.assert_array_equal(
        camera.fundamental_matrices(port, src, tgt),
        jax_camera.fundamental_matrices(ref, src, tgt))
    np.testing.assert_array_equal(camera.fundamental_matrix(port[0], port[3]),
                                  jax_camera.fundamental_matrix(ref[0],
                                                                ref[3]))


def test_segment_cache_key_and_roundtrip(tmp_path, rng, capsys):
    segs = rng.uniform(0, 900, (37, 4))
    segments_cache.store(str(tmp_path), 7, (960, 1280), 3000, segs)
    assert segments_cache._path(str(tmp_path), 7, (960, 1280), 3000) == \
        jax_cache._path(str(tmp_path), 7, (960, 1280), 3000)
    np.testing.assert_array_equal(
        jax_cache.load(str(tmp_path), 7, (960, 1280), 3000), segs)
    np.testing.assert_array_equal(
        segments_cache.load(str(tmp_path), 7, (960, 1280), 3000), segs)
    assert segments_cache.load(str(tmp_path), 8, (960, 1280), 3000) is None
    # a reference cache of view 9 is imported as JAX imports it; this one
    # is empty, so both warn and give None (the view is detected again)
    open(tmp_path / "segments_L3D++_9_1280x960_3000.bin", "wb").close()
    assert segments_cache.load(str(tmp_path), 9, (960, 1280), 3000) is None
    assert jax_cache.load(str(tmp_path), 9, (960, 1280), 3000) is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert "unreadable reference segment cache" in out[0]


def _lines(rng, cls):
    return [cls(segments3d=rng.normal(0, 10, (int(rng.integers(1, 4)), 6)),
                residuals=np.column_stack([
                    rng.integers(0, 26, (5, 2)).astype(float),
                    rng.uniform(0, 3000, (5, 4))]))
            for _ in range(12)]


@pytest.mark.parametrize("fmt", ["txt", "stl", "obj"])
def test_writer_bytes_match_jax(tmp_path, fmt):
    lines = _lines(np.random.default_rng(3), writers.FinalLine3D)
    ref = [jax_writers.FinalLine3D(l.segments3d, l.residuals) for l in lines]
    getattr(writers, f"save_{fmt}")(str(tmp_path / "a"), lines)
    getattr(jax_writers, f"save_{fmt}")(str(tmp_path / "b"), ref)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def _graph(rng, n=300, e=1500):
    i = rng.integers(0, n, e)
    j = rng.integers(0, n, e)
    # quantised weights: ties must keep input order (stable sort)
    w = (rng.integers(50, 100, e) / 100).astype(np.float32)
    return (np.concatenate([i, j]), np.concatenate([j, i]),
            np.concatenate([w, w]), n)


def test_cluster_edges_native_matches_jax(rng):
    i, j, w, n = _graph(rng)
    assert clustering._native_lib() is not None
    np.testing.assert_array_equal(clustering.cluster_edges(i, j, w, n),
                                  jax_clustering.cluster_edges(i, j, w, n))


def test_cluster_python_matches_jax(rng):
    i, j, w, n = _graph(rng, n=120, e=400)
    order = np.argsort(w, kind="stable")
    a = clustering.cluster_python(i[order].astype(np.int32),
                                  j[order].astype(np.int32), w[order], n, 3.0)
    b = jax_clustering._cluster_python(i[order], j[order], w[order], n, 3.0)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, clustering.cluster_edges(i, j, w, n))


def test_fit_project_and_sweep_match_jax(rng):
    C = 40
    members = rng.integers(0, C, 400)
    pts = rng.normal(0, 1, (800, 3)) + np.repeat(
        rng.normal(0, 5, (C, 3)), 20, axis=0)[np.concatenate(
            [members, members])]
    cid = np.concatenate([members, members])
    a = fitting.fit_lines_np(pts, cid, C)
    b = jax_fitting.fit_lines_np(pts, cid, C)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, np.asarray(y))
    d = a.P2 - a.P1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (a.P1[members], d[members], rng.normal(0, 3, (400, 3)),
            rng.normal(size=(400, 3)), rng.normal(size=(400, 3)))
    for x, y in zip(fitting.project_members_onto_lines_np(*args),
                    jax_fitting.project_members_onto_lines_np(*args)):
        np.testing.assert_array_equal(x, y)
    s1, s2, ok = fitting.project_members_onto_lines_np(*args)
    cams = rng.integers(0, 6, 400)
    for x, y in zip(sweep.sweep_all_flat(members, s1, s2, ok, cams, C, 3),
                    jax_sweep.sweep_all_flat(members, s1, s2, ok, cams, C,
                                             3)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("visibility", [2, 3, 5])
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_sweep_clusters_on_cpu_tensors_match_jax(name, visibility):
    """The sweep stage's wrapper on CPU tensors gives JAX's projections
    swept by JAX's ``sweep_all_flat``, and the reference views of JAX's
    pipeline (the camera of the longest member 2D segment, the first
    member winning ties), bit for bit; the stats count the call."""
    case = sweep_case(name, seed=10 + visibility)
    mc, mv, ms, C = case["mc"], case["mv"], case["ms"], case["C"]
    stats = {}
    got = sweep.sweep_clusters(*sweep_arguments(case, visibility),
                               stats=stats)
    s1, s2, ok = jax_fitting.project_members_onto_lines_np(
        case["line_P1"][mc], case["line_dir"][mc], case["cam_C"][mv],
        case["r1"][mv, ms], case["r2"][mv, ms])
    want = jax_sweep.sweep_all_flat(mc, s1, s2, ok, mv, C, visibility)
    seg2d = case["segs"]
    lens2d = np.hypot(seg2d[mv, ms, 2] - seg2d[mv, ms, 0],
                      seg2d[mv, ms, 3] - seg2d[mv, ms, 1])
    ref_view = np.zeros(C, np.int32)
    o_rv = np.lexsort((-np.arange(len(mc)), lens2d, mc))
    ref_view[mc[o_rv]] = mv[o_rv]
    assert len(got) == 4
    for g, w in zip(got, (*want, ref_view)):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    assert stats == dict(clusters=C, members=len(mc),
                         intervals=len(want[0]), large_clusters=0)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import sys
        import torch
        import importlib, pkgutil
        import line3dpp_tpu_torch as lt
        names = [m.name for m in pkgutil.walk_packages(
            lt.__path__, "line3dpp_tpu_torch.")]
        assert len(names) >= 25, names
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "line3dpp_tpu" or m.startswith("line3dpp_tpu.")]
        assert not bad, bad
        torch.cuda.is_available = lambda: False
        try:
            lt.Line3D(lt.Config(optimize=False))
        except RuntimeError as e:
            assert "device='cpu'" in str(e)
        else:
            raise AssertionError("Line3D() ran without a card")
        lt.Line3D(lt.Config(optimize=False), device="cpu")
        assert lt.Line3D(device="cpu").config.optimize
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "line3dpp_tpu." not in src.replace("line3dpp_tpu_torch", "")
    assert "import line3dpp_tpu\n" not in src


def test_chip_smoke_imports_leave_jax_unloaded():
    """Every module that chip_smoke.py imports anywhere in its source,
    imported in a fresh process: neither JAX nor the JAX package loads."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names)
    assert "line3dpp_tpu_torch.ops.bundling" in mods and "torch" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {sorted(mods)!r}:
            try:
                importlib.import_module(name)
            except ModuleNotFoundError as e:
                # "from module import function" gives module.function here
                assert e.name == name, (name, e)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "line3dpp_tpu")]
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_line3d_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.Line3D(lt.Config(optimize=False))
    assert lt.Line3D(lt.Config(optimize=False), device="cpu").device.type \
        == "cpu"


@pytest.mark.parametrize("kw,item", [
    (dict(perform_rdd=True), 13),                  # optimize defaults on
    (dict(optimize=False, perform_rdd=True), 13),
    (dict(optimize=False, collinearity_t=2.0), 13),
    (dict(optimize=False, split_bimodal_t=1.1), 13),
    (dict(optimize=False, cluster_strong_min=3.0), 13),
    (dict(optimize=False, match_rel_cut=0.5), 13),
    (dict(optimize=False, view_block=4), 14),
    (dict(optimize=False, knn=0), 14),
])
def test_options_outside_the_slice_raise(kw, item):
    """Every option of items 13 and 14 has been ported (the name is kept
    from when they raised) and constructs; item 14's also run phase 2 on
    a small scene, the blocked path where a block is smaller than the
    scene (tests/test_torch_features.py and test_torch_blocked.py run
    them end to end)."""
    pipe = lt.Line3D(lt.Config(**kw), device="cpu")
    assert pipe.config == lt.Config(**kw)
    if item == 14:
        from tests.test_config_modes import _scene

        pipe = lt.Line3D(dataclasses.replace(pipe.config,
                                             max_line_segments=64),
                         device="cpu")
        cams, P, Q = _scene(np.random.default_rng(3))
        for i, c in enumerate(cams):
            pipe.add_view(i, lt.Camera(c.K, c.R, c.t, c.width, c.height),
                          np.hstack([c.project(P), c.project(Q)]))
        pipe.match_images()
        st = pipe._last_state
        assert ("edges_flat" in st) == (kw.get("view_block", 0) > 0)
        assert bool(st["est"].est_valid.any())
