"""The port's Line3D against the JAX package's, end to end on the CPU.

Slice end to end: bundled views 0-5, max_line_segments=800,
num_neighbors=4, Config(optimize=False).  Measured here: both give 117
lines and the port reaches count_f1 1.0 and segment F1 1.0 against JAX at
1% scene scale.  The bounds (line count +-2, count_f1 >= 0.99, segment
F1 >= 0.99) leave room for the float32 rounding differences of the
matcher (tests/test_torch_matching.py) and nothing more.
"""

import numpy as np
import pytest

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch.utils import golden
from line3dpp_tpu_torch.utils.testdata import load_views

CFG = dict(optimize=False, max_line_segments=800, num_neighbors=4)


def _run(pkg, pipe_kw, views):
    pipe = pkg.Line3D(pkg.Config(**CFG), **pipe_kw)
    for v in views:
        pipe.add_view(v.cam_id, pkg.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    pipe.match_images()
    return pipe, pipe.reconstruct_3d_lines()


@pytest.fixture(scope="module")
def six_views():
    views = load_views(range(6))
    port_pipe, port = _run(lt, dict(device="cpu"), views)
    jax_pipe, ref = _run(l3d, {}, views)
    return port_pipe, port, jax_pipe, ref


def test_line3d_six_views_matches_jax(six_views):
    _, port, _, ref = six_views
    assert len(ref) > 100
    assert abs(len(port) - len(ref)) <= 2
    p = [l.segments3d for l in port]
    r = [l.segments3d for l in ref]
    tol = 0.01 * golden.scene_scale(np.concatenate(r))
    assert golden.line_match_metrics(p, r, tol)["count_f1"] >= 0.99
    assert golden.segment_set_metrics(np.concatenate(p), np.concatenate(r),
                                      tol)["f1"] >= 0.99


def test_neighbour_table_matches_jax(six_views):
    """Geometric neighbours with 'ordered' back-edges: the same table."""
    port_pipe, _, jax_pipe, _ = six_views
    np.testing.assert_array_equal(port_pipe._last_state["neighbor_ids"],
                                  jax_pipe._last_state["neighbor_ids"])


def test_residuals_and_writers(six_views, tmp_path):
    """Every line carries residual rows [camID segID p q] of its member
    segments, and the TXT file parses back to the same lines."""
    port_pipe, port, _, _ = six_views
    segs = {v: port_pipe._views[v].segments for v in port_pipe._views}
    for line in port:
        assert len(line.residuals) >= 3
        for cam, seg, *pq in line.residuals:
            np.testing.assert_allclose(segs[int(cam)][int(seg)], pq,
                                       rtol=1e-6)
    port_pipe.save_txt(str(tmp_path / "m.txt"))
    back = golden.parse_lines3d_txt(str(tmp_path / "m.txt"))
    assert len(back) == len(port)
    for a, b in zip(back, port):
        np.testing.assert_allclose(a.segments3d, b.segments3d, rtol=1e-5,
                                   atol=1e-5)


def test_worldpoint_neighbours_match_jax(rng):
    """The worldpoint-overlap branch of the neighbour choice (host only)."""
    views = load_views(range(8))
    wps = {v.cam_id: sorted(set(rng.integers(0, 400, 150).tolist())
                            | set(range(40 * v.cam_id, 40 * v.cam_id + 60)))
           for v in views}
    out = []
    for pkg, kw in ((lt, dict(device="cpu")), (l3d, {})):
        pipe = pkg.Line3D(pkg.Config(**CFG), **kw)
        for v in views:
            pipe.add_view(v.cam_id, pkg.Camera(v.K, v.R, v.t, v.width,
                                               v.height), v.segments[:5],
                          wps[v.cam_id])
        cams = [pipe._views[c].camera for c in sorted(pipe._views)]
        out.append(pipe._visual_neighbors(sorted(pipe._views), cams, 4))
    assert out[0] == out[1]
    assert all(len(n) == 4 for n in out[0].values())


def test_fixed_neighbours_and_symmetrization():
    pipe = lt.Line3D(lt.Config(match_symmetrization="full", **CFG),
                     device="cpu")
    for v in load_views(range(4)):
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    pipe.set_visual_neighbors(0, [3])
    inp = pipe.step_inputs()
    nbr, pv = inp["neighbor_ids"], inp["pair_valid"]
    assert list(nbr[0][pv[0]])[0] == 3
    for i in range(4):            # "full": every edge has its back-edge
        for j in nbr[i][pv[i]]:
            assert i in nbr[j][pv[j]]


def test_call_order_errors():
    pipe = lt.Line3D(lt.Config(**CFG), device="cpu")
    with pytest.raises(ValueError, match="no views"):
        pipe.match_images()
    with pytest.raises(RuntimeError, match="match_images"):
        pipe.reconstruct_3d_lines()


def test_two_views_give_no_lines():
    """Below visibility 3 nothing survives, without error."""
    pipe = lt.Line3D(lt.Config(**CFG), device="cpu")
    for v in load_views(range(2)):
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    pipe.match_images()
    assert pipe.reconstruct_3d_lines() == []
