"""The port's line bundling against the JAX package's, on the CPU.

The seeded problems are those of ``tests/test_bundling.py`` (6 lines seen in
5 views, endpoints perturbed by 0.02).  Tolerances, with what was measured:

* Cayley/Plücker functions: atol 1e-5 of JAX's on the same inputs (measured
  3.8e-6), and the round trip of ``tests/test_bundling.py`` at its atol 1e-4.
* Residuals and Jacobians (the port's written-out forward tangents against
  ``jax.jacfwd``): rtol 1e-4 with atol 1e-3 of the largest entry (measured:
  residuals 3.1e-5 and Jacobians 1.9e-7 of the largest entry).
* ``lm_cost``: rtol 5e-5 per cluster (measured 1.5e-5).  The residual
  is a difference of products of ~1000 px coordinates that leaves ~10 px,
  so float32 rounding alone moves it by ~1e-5 of its value between two
  orders of the same operations; rtol 1e-5 holds for 5 of the 6 clusters.
* ``lm_optimize``, 25 and 250 iterations: the Levenberg-Marquardt
  trajectories of two float32 implementations part once a cost comparison
  falls the other way, so the parameters are not compared; the total cost
  is, at rtol 2e-2 (from exact observations the cost falls from 435.6 to
  5.611e-8 px^2 in the port and 5.635e-8 in JAX, 0.4% apart, at 25 and at
  250 iterations), and the
  recovered lines by the JAX test's own bounds (direction cosine > 0.9999,
  offset < 5e-3).
* ``optimize_cluster_lines`` captures what JAX captures, minus its padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import line3dpp_tpu as l3d
from line3dpp_tpu.camera import CameraBatch as JCameraBatch
from line3dpp_tpu.camera import rotation_from_rpy
from line3dpp_tpu.ops import bundling as jb
import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch.camera import CameraBatch
from line3dpp_tpu_torch import obs
from line3dpp_tpu_torch.ops import bundling, kernels


def _scene(rng, n_lines=6, n_views=5):
    """tests/test_bundling.py::_scene, draw for draw."""
    P1 = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(n_lines, 3))
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    P2 = P1 + d * rng.uniform(0.8, 1.6, size=(n_lines, 1))
    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    cams = []
    for i in range(n_views):
        R = rotation_from_rpy(rng.normal() * 0.02, -0.05 * i + 0.12,
                              rng.normal() * 0.02)
        C = np.array([0.5 * i - 1.2, rng.normal() * 0.05,
                      rng.normal() * 0.05])
        cams.append((K, R, -R @ C, 1920, 1080))
    return P1, P2, cams


@pytest.fixture(scope="module")
def problem():
    """The perturbed-lines problem, and JAX's capture and result on it."""
    rng = np.random.default_rng(0)
    n_lines, n_views = 6, 5
    P1, P2, cams = _scene(rng, n_lines, n_views)
    jcams = [l3d.Camera(*c) for c in cams]
    segs = np.zeros((n_views, n_lines, 4), np.float32)
    for i, cam in enumerate(jcams):
        segs[i] = np.hstack([cam.project(P1), cam.project(P2)])
    mc = np.tile(np.arange(n_lines, dtype=np.int32), n_views)
    mv = np.repeat(np.arange(n_views, dtype=np.int32), n_lines)
    ms = np.tile(np.arange(n_lines, dtype=np.int32), n_views)
    pert1 = (P1 + rng.normal(size=P1.shape) * 0.02).astype(np.float32)
    pert2 = (P2 + rng.normal(size=P2.shape) * 0.02).astype(np.float32)
    jcap = {}
    jst = dict(cb=JCameraBatch.from_cameras(jcams, sigma_p=2.5,
                                            translation=np.zeros(3)),
               segs=segs)
    jout = jb.optimize_cluster_lines(pert1, pert2, mc, mv, ms, n_lines, jst,
                                     l3d.Config(), _capture=jcap)
    st = dict(cb=CameraBatch.from_cameras(
        [lt.Camera(*c) for c in cams], sigma_p=2.5,
        translation=np.zeros(3)), segs=segs)
    return dict(P1=P1, P2=P2, pert1=pert1, pert2=pert2, mc=mc, mv=mv, ms=ms,
                C=n_lines, st=st, jcap=jcap, jout=jout)


def _jax_lm_args(cap):
    return [jnp.asarray(cap[k]) for k in bundling.LM_ARRAYS]


def test_cayley_plucker_match_jax_and_round_trip(rng):
    P1 = (rng.normal(size=(20, 3)) * 3).astype(np.float32)
    P2 = P1 + rng.normal(size=(20, 3)).astype(np.float32)
    m, v = bundling.plucker_from_endpoints(torch.from_numpy(P1),
                                           torch.from_numpy(P2))
    jm, jv = jb.plucker_from_endpoints(jnp.asarray(P1), jnp.asarray(P2))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    s, w = bundling.params_from_plucker(m, v)
    js, jw = jb.params_from_plucker(jm, jv)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)
    U = bundling.cayley_to_rotation(s)
    np.testing.assert_allclose(U.numpy(),
                               np.asarray(jb.cayley_to_rotation(js)),
                               atol=1e-5)
    np.testing.assert_allclose(bundling.rotation_to_cayley(U).numpy(),
                               s.numpy(), atol=1e-4)
    m2, v2 = bundling.plucker_from_params(s, w)
    scale = np.sqrt(np.linalg.norm(m.numpy(), axis=1) ** 2 + 1.0)
    np.testing.assert_allclose(m2.numpy() * scale[:, None], m.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(v2.numpy() * scale[:, None], v.numpy(),
                               atol=1e-4)


def test_line_through_the_origin_gets_a_valid_frame():
    """m = 0: the frame's first axis is some normal to v, its second v."""
    P1 = torch.zeros((2, 3))
    P2 = torch.tensor([[-0.4, -0.5, 0.8], [1.0, 0.0, 0.0]])
    m, v = bundling.plucker_from_endpoints(P1, P2)
    s, w = bundling.params_from_plucker(m, v)
    U = bundling.cayley_to_rotation(s)
    np.testing.assert_allclose(U[..., :, 1].numpy(), v.numpy(), atol=1e-5)
    np.testing.assert_allclose((U.transpose(-1, -2) @ U).numpy(),
                               np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-5)
    m2, v2 = bundling.plucker_from_params(s, w)
    np.testing.assert_allclose(m2.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(v2.numpy(), v.numpy(), atol=1e-5)


def test_capture_equals_jax_capture_without_padding(problem):
    cap = {}
    bundling.optimize_cluster_lines(
        problem["pert1"], problem["pert2"], problem["mc"], problem["mv"],
        problem["ms"], problem["C"], problem["st"], lt.Config(),
        iterations=1, device="cpu", _capture=cap)
    stripped = bundling.problem_from_capture(problem["jcap"], "cpu")
    assert stripped["C"] == cap["C"] == problem["C"]
    assert problem["jcap"]["Cpad"] > problem["C"]
    for k in bundling.LM_ARRAYS:
        assert stripped[k].shape == cap[k].shape, k
        np.testing.assert_allclose(cap[k], stripped[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)


def test_residuals_and_jacobians_match_jax(problem):
    p = bundling.problem_from_capture(problem["jcap"], "cpu")
    obs = [p[k] for k in bundling.LM_ARRAYS[2:]]
    r, J = bundling._res_and_jac(p["params0"][p["obs_cluster"].long()], *obs)
    jargs = [jnp.asarray(p[k].numpy()) for k in bundling.LM_ARRAYS]
    jr, jJ = jb._res_and_jac(jargs[0][jargs[1]], *jargs[2:])
    assert J.shape == (30, 2, 4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4,
                               atol=1e-3 * float(np.abs(jr).max()))
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=1e-4,
                               atol=1e-3 * float(np.abs(jJ).max()))


def test_tangents_equal_forward_mode_autodiff_in_float64(problem):
    """The written-out tangents against ``torch.func.jacfwd`` of the
    residual, both in float64: rtol 1e-9 (measured 6e-11)."""
    p = bundling.problem_from_capture(problem["jcap"], "cpu")
    obs = [p[k].double() for k in bundling.LM_ARRAYS[2:]]
    params = p["params0"][p["obs_cluster"].long()].double()
    r, J = bundling._res_and_jac(params, *obs)
    want = torch.func.vmap(torch.func.jacfwd(bundling._obs_residual))(
        params, *obs)
    assert J.dtype == want.dtype == torch.float64
    scale = float(want.abs().max())
    np.testing.assert_allclose(J.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(
        r.numpy(), bundling._obs_residual(params, *obs).numpy(), rtol=1e-9)


def test_lm_cost_matches_jax(problem):
    cap = problem["jcap"]
    p = bundling.problem_from_capture(cap, "cpu")
    got = bundling.lm_cost(*(p[k] for k in bundling.LM_ARRAYS),
                           num_clusters=p["C"])
    want = jb.lm_cost(*_jax_lm_args(cap), num_clusters=int(cap["Cpad"]))
    assert float(got.min()) > 1.0         # the perturbed start is far off
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:p["C"]],
                               rtol=5e-5)
    # the order of the observations does not matter
    perm = torch.from_numpy(np.random.default_rng(1).permutation(30))
    again = bundling.lm_cost(p["params0"], *(p[k][perm] for k in
                                             bundling.LM_ARRAYS[1:]),
                             num_clusters=p["C"])
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="obs_cluster"):
        bundling.lm_cost(*(p[k] for k in bundling.LM_ARRAYS), num_clusters=3)


@pytest.mark.parametrize("iterations", [25, 250])
def test_lm_optimize_reaches_jax_cost(problem, iterations):
    cap = problem["jcap"]
    p = bundling.problem_from_capture(cap, "cpu")
    args = [p[k] for k in bundling.LM_ARRAYS]
    params = bundling.lm_optimize(*args, num_clusters=p["C"],
                                  iterations=iterations)
    assert params.shape == (p["C"], 4) and params.dtype == torch.float32
    cost = float(bundling.lm_cost(params, *args[1:],
                                  num_clusters=p["C"]).sum())
    jparams = jb.lm_optimize(*_jax_lm_args(cap),
                             num_clusters=int(cap["Cpad"]),
                             iterations=iterations)
    jcost = float(np.asarray(jb.lm_cost(
        jparams, *_jax_lm_args(cap)[1:],
        num_clusters=int(cap["Cpad"])))[:p["C"]].sum())
    start = float(bundling.lm_cost(*args, num_clusters=p["C"]).sum())
    assert cost < 1e-4 * start
    assert cost == pytest.approx(jcost, rel=2e-2)
    # a second run takes the same steps
    again = bundling.lm_optimize(*args, num_clusters=p["C"],
                                 iterations=iterations)
    np.testing.assert_array_equal(again.numpy(), params.numpy())


def test_lm_optimize_on_cpu_tensors_runs_the_plain_loop(problem,
                                                       monkeypatch):
    """CPU tensors take ``lm_optimize_plain``: no kernel library is
    loaded, no kernel launch is counted, and each iteration still records
    its ``recon.bundle.lm_iteration`` span."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)
    p = bundling.problem_from_capture(problem["jcap"], "cpu")
    args = [p[k] for k in bundling.LM_ARRAYS]
    before = kernels.LAUNCHES["lm_bundle"]
    stats = {}
    obs.clear()
    with obs.recording():
        got = bundling.lm_optimize(*args, num_clusters=p["C"], iterations=4,
                                   stats=stats)
    spans = obs.summary(obs.records()[-1])
    obs.clear()
    assert kernels.LAUNCHES["lm_bundle"] == before
    assert spans["recon.bundle.lm_iteration"]["count"] == 4
    assert stats["launches"] == 0
    acc = stats["accepted"]
    assert acc.dtype == torch.int32 and acc.shape == (p["C"],)
    assert 0 < int(acc.sum()) and int(acc.max()) <= 4
    np.testing.assert_array_equal(
        got.numpy(), bundling.lm_optimize_plain(
            *args, num_clusters=p["C"], iterations=4).numpy())


def _kernel_arguments(problem):
    p = bundling.problem_from_capture(problem["jcap"], "cpu")
    return [p[k] for k in bundling.LM_ARRAYS], p["C"]


@pytest.mark.parametrize("index,bad,match", [
    (0, lambda x: x.double(), "params0: dtype"),
    (0, lambda x: x[:-1], "params0: shape"),
    (1, lambda x: x.float(), "obs_cluster: dtype"),
    (1, lambda x: x[:, None], "obs_cluster: shape"),
    (2, lambda x: x.half(), "KinvT: dtype"),
    (3, lambda x: x[:, :2], "R: shape"),
    (4, lambda x: x[:-1], "t: shape"),
    (7, lambda x: x.double(), "seg_dir: dtype"),
    (5, lambda x: x.t().contiguous().t(), "p1h: on cpu"),
], ids=["params0-dtype", "params0-shape", "cluster-dtype", "cluster-shape",
        "KinvT-dtype", "R-shape", "t-shape", "seg_dir-dtype", "cpu"])
def test_the_kernel_wrapper_checks_its_arguments_without_a_card(
        problem, monkeypatch, index, bad, match):
    """``lm_optimize_cuda`` refuses what the kernel does not take before
    it touches the card or loads the library (types and shapes first, then
    the device)."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)
    args, C = _kernel_arguments(problem)
    args[index] = bad(args[index])
    if match.endswith("on cpu"):
        match = "on cpu, expected one CUDA device"
    with pytest.raises(ValueError, match=match):
        bundling.lm_optimize_cuda(*args, num_clusters=C, iterations=2)


def test_optimize_cluster_lines_fills_its_stats(problem):
    stats, cap = {}, {}
    bundling.optimize_cluster_lines(
        problem["pert1"], problem["pert2"], problem["mc"], problem["mv"],
        problem["ms"], problem["C"], problem["st"], lt.Config(),
        iterations=25, device="cpu", stats=stats, _capture=cap)
    want = {}
    bundling.lm_optimize(*(torch.from_numpy(cap[k])
                           for k in bundling.LM_ARRAYS),
                         num_clusters=cap["C"], iterations=25, stats=want)
    assert stats == dict(clusters=problem["C"],
                         observations=len(problem["mc"]), iterations=25,
                         accepted_steps=int(want["accepted"].sum()),
                         launches=0)
    assert 0 < stats["accepted_steps"] <= 25 * problem["C"]


def test_optimize_cluster_lines_recovers_lines_like_jax(problem):
    newP1, newP2, ndir = bundling.optimize_cluster_lines(
        problem["pert1"], problem["pert2"], problem["mc"], problem["mv"],
        problem["ms"], problem["C"], problem["st"], lt.Config(),
        device="cpu")
    P1, P2 = problem["P1"], problem["P2"]
    true_dir = (P2 - P1) / np.linalg.norm(P2 - P1, axis=1, keepdims=True)
    jP1, _, jdir = problem["jout"]
    for c in range(problem["C"]):
        assert abs(float(ndir[c] @ true_dir[c])) > 0.9999
        w = newP1[c] - P1[c]
        assert np.linalg.norm(w - (w @ true_dir[c]) * true_dir[c]) < 5e-3
        # and close to JAX's line: direction and offset
        assert abs(float(ndir[c] @ jdir[c])) > 0.99999
        w = newP1[c] - jP1[c]
        assert np.linalg.norm(w - (w @ jdir[c]) * jdir[c]) < 5e-3


def test_bundling_without_a_card_raises(problem, monkeypatch):
    """``optimize_cluster_lines`` bundles on the card unless asked for the
    CPU, as ``Line3D`` and ``lsd.detect`` do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bundling.optimize_cluster_lines(
            problem["pert1"], problem["pert2"], problem["mc"], problem["mv"],
            problem["ms"], problem["C"], problem["st"], lt.Config(),
            iterations=1)


def test_default_config_constructs_and_bundles():
    """``Line3D()`` takes the default ``Config`` (optimize on)."""
    pipe = lt.Line3D(device="cpu")
    assert pipe.config.optimize and pipe.config.max_iter_optim == 250


# ---------------------------------------------------------------------------
# the slice as a whole: cached views 0-5 under the default Config()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def six_views_bundled():
    from line3dpp_tpu_torch.utils.testdata import load_views

    views = load_views(range(6))
    kw = dict(max_line_segments=800, num_neighbors=4)
    out = []
    for pkg, pipe_kw in ((lt, dict(device="cpu")), (l3d, {})):
        pipe = pkg.Line3D(pkg.Config(**kw), **pipe_kw)
        assert pipe.config.optimize
        for v in views:
            pipe.add_view(v.cam_id, pkg.Camera(v.K, v.R, v.t, v.width,
                                               v.height), v.segments)
        pipe.match_images()
        out.append(pipe.reconstruct_3d_lines())
    plain = lt.Line3D(lt.Config(optimize=False, **kw), device="cpu")
    for v in views:
        plain.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                       v.segments)
    plain.match_images()
    return out[0], out[1], plain.reconstruct_3d_lines()


def test_line3d_default_config_six_views_matches_jax(six_views_bundled):
    """Bundled lines of views 0-5 (max_line_segments=800, num_neighbors=4,
    250 LM iterations).  Measured: 117 lines from each package, count_f1
    1.0 and segment F1 1.0 at 1% scene scale, count_f1 1.0 at 0.1% and
    0.991 at 0.01%.  Bounds: count within 2 and both F1 >= 0.99 at 1% (as
    the unbundled run in tests/test_torch_pipeline.py), count_f1 >= 0.99
    at 0.1%.  The bundling moves the lines: against the port's own
    unbundled lines the largest endpoint shift is 0.048 of the scene scale
    (bound: > 1e-3)."""
    from line3dpp_tpu_torch.utils import golden

    port, ref, plain = six_views_bundled
    assert len(ref) > 100
    assert abs(len(port) - len(ref)) <= 2
    p = [l.segments3d for l in port]
    r = [l.segments3d for l in ref]
    scale = golden.scene_scale(np.concatenate(r))
    assert golden.line_match_metrics(p, r, 0.01 * scale)["count_f1"] >= 0.99
    assert golden.segment_set_metrics(np.concatenate(p), np.concatenate(r),
                                      0.01 * scale)["f1"] >= 0.99
    assert golden.line_match_metrics(p, r, 1e-3 * scale)["count_f1"] >= 0.99
    assert len(plain) == len(port)
    moved = max(float(np.abs(a.segments3d[0] - b.segments3d[0]).max())
                for a, b in zip(port, plain)
                if len(a.segments3d) == len(b.segments3d))
    assert moved > 1e-3 * scale
