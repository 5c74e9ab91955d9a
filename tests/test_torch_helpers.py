"""The JAX package's helpers that nothing on its main path calls, against
their ports, on the CPU: the eight ``ops/geometry`` functions
(``unproject``, ``seg3d_dir``, ``seg3d_length``, ``angle_deg_undirected``,
``point_to_line_dist``, ``line_through``, ``project_points``,
``closest_point_params_line_to_ray``) on seeded float32 arrays, and
``utils/golden.line_match_assignment`` on the committed golden TXT against
a seeded perturbed copy.

Tolerances: the geometry within rtol 1e-5 and atol 1e-5 (in the output's
units: pixels, degrees, scene units); the port writes its K=3 sums out in
a fixed order where XLA may reduce in another, a few float32 ulps, and an
angle near 0 or 90 degrees takes ``acos``'s slope, so the directions are
drawn away from those.  Validity masks and the matching are equal.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from line3dpp_tpu.ops import geometry as jgeo
from line3dpp_tpu.utils import golden as jgolden
from line3dpp_tpu_torch.ops import geometry
from line3dpp_tpu_torch.utils import golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(
    REPO, "testdata", "out",
    "Line3D-TPU__W_FULL__N_10__sigmaP_2.5__sigmaA_10__epiOverlap_0.25"
    "__kNN_10__vis_3.txt")
RTOL = ATOL = 1e-5
B = (7, 33)   # batch shape


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _angle_pairs(rng):
    """Unit directions whose undirected angle lies in 5-85 degrees, away
    from acos's steep ends."""
    d1 = _unit(rng, B)
    perp = np.cross(d1, _unit(rng, B))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    a = np.radians(rng.uniform(5, 85, B) + 90 * rng.integers(0, 2, B))
    d2 = np.cos(a)[..., None] * d1 + np.sin(a)[..., None] * perp
    return d1, d2


def _camera(rng):
    K = np.array([[1200.0, 0, 960], [0, 1100.0, 540], [0, 0, 1]])
    th = rng.normal(size=3) * 0.2
    Rx = np.array([[1, 0, 0], [0, np.cos(th[0]), -np.sin(th[0])],
                   [0, np.sin(th[0]), np.cos(th[0])]])
    Ry = np.array([[np.cos(th[1]), 0, np.sin(th[1])], [0, 1, 0],
                   [-np.sin(th[1]), 0, np.cos(th[1])]])
    X = rng.uniform([-3, -2, 6], [3, 2, 14], B + (3,))
    return (np.broadcast_to(K, B + (3, 3)), np.broadcast_to(Ry @ Rx,
                                                            B + (3, 3)),
            rng.normal(size=3) * 0.3, X)


CASES = {
    "unproject": lambda r: (r.normal(size=B + (3,)), _unit(r, B),
                            r.uniform(0.5, 40, B)),
    "seg3d_dir": lambda r: (r.normal(size=B + (3,)) * 5,
                            r.normal(size=B + (3,)) * 5),
    "seg3d_length": lambda r: (r.normal(size=B + (3,)) * 5,
                               r.normal(size=B + (3,)) * 5),
    "angle_deg_undirected": _angle_pairs,
    "point_to_line_dist": lambda r: (r.normal(size=B + (3,)) * 4,
                                     r.normal(size=B + (3,)), _unit(r, B)),
    "line_through": lambda r: (np.concatenate(
        [r.uniform(0, 1000, B + (2,)), np.ones(B + (1,))], -1),
        np.concatenate([r.uniform(0, 1000, B + (2,)), np.ones(B + (1,))],
                       -1)),
    "project_points": _camera,
    "closest_point_params_line_to_ray": lambda r: (
        r.normal(size=B + (3,)) * 3, _unit(r, B), r.normal(size=B + (3,)),
        _unit(r, B)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_helper_matches_jax(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    args = [np.ascontiguousarray(a, np.float32) for a in CASES[name](rng)]
    got = getattr(geometry, name)(*(torch.from_numpy(a) for a in args))
    want = getattr(jgeo, name)(*(jnp.asarray(a) for a in args))
    if isinstance(want, tuple):       # closest_point_params_line_to_ray
        (got, got_valid), (want, want_valid) = got, want
        np.testing.assert_array_equal(got_valid.numpy(),
                                      np.asarray(want_valid))
        assert got_valid.all()
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_closest_point_params_flags_parallel_lines():
    u = torch.tensor([[1.0, 0.0, 0.0]])
    s, valid = geometry.closest_point_params_line_to_ray(
        torch.zeros(1, 3), u, torch.ones(1, 3), 2 * u)
    assert not bool(valid[0]) and float(s[0]) == 0.0


def test_line_match_assignment_matches_jax():
    """The golden lines against a copy with a quarter of the lines
    removed, the rest shuffled and their endpoints moved by 0.4% of the
    scene scale (tolerance 1%)."""
    gold = [g.segments3d for g in golden.parse_lines3d_txt(GOLDEN)]
    scale = golden.scene_scale(np.concatenate(gold))
    rng = np.random.default_rng(0)
    keep = rng.permutation(len(gold))[: 3 * len(gold) // 4]
    pred = [gold[i] + rng.normal(scale=0.004 * scale, size=gold[i].shape)
            for i in keep]
    got = golden.line_match_assignment(pred, gold, 0.01 * scale)
    want = jgolden.line_match_assignment(pred, gold, 0.01 * scale)
    assert got == want
    assert 0.8 * len(pred) < len(got) <= len(pred)
    assert golden.line_match_assignment([], gold, 1.0) == {}
