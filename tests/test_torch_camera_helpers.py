"""The port's camera helpers against the JAX package's on seeded inputs
(host float64 numpy in both; within 1e-12)."""

import numpy as np
import pytest

from line3dpp_tpu import camera as jcam
from line3dpp_tpu_torch import camera as tcam


@pytest.mark.parametrize("seed", range(4))
def test_rotation_from_quaternion(seed):
    rng = np.random.default_rng(seed)
    for q in list(rng.normal(size=(20, 4))) + [np.zeros(4),
                                                np.array([1.0, 0, 0, 0])]:
        np.testing.assert_allclose(tcam.rotation_from_quaternion(q),
                                   jcam.rotation_from_quaternion(q),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_decompose_projection_matrix(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[rng.uniform(500, 1500), rng.normal() * 2,
                   rng.uniform(300, 700)],
                  [0, rng.uniform(500, 1500), rng.uniform(200, 500)],
                  [0, 0, 1.0]])
    R = tcam.rotation_from_rpy(*rng.normal(size=3))
    t = rng.normal(size=3)
    P = K @ np.hstack([R, t[:, None]]) * rng.uniform(-3, 3)
    got = tcam.decompose_projection_matrix(P)
    want = jcam.decompose_projection_matrix(P)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0], K, atol=1e-6)
    np.testing.assert_allclose(got[1], R, atol=1e-9)


def test_rpy_and_fundamental_matrix(rng):
    for _ in range(5):
        rpy = rng.normal(size=3)
        np.testing.assert_allclose(tcam.rotation_from_rpy(*rpy),
                                   jcam.rotation_from_rpy(*rpy),
                                   rtol=0, atol=1e-12)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    cams = []
    for pkg in (tcam, jcam):
        pair = [pkg.Camera(K, pkg.rotation_from_rpy(0.1 * i, -0.05, 0.02),
                           np.array([0.3 * i, 0.1, -0.2]), 640, 480)
                for i in range(2)]
        cams.append(pkg.fundamental_matrix(*pair))
    np.testing.assert_allclose(cams[0], cams[1], rtol=0, atol=1e-12)
