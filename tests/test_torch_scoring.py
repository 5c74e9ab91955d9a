"""Port scoring (line3dpp_tpu_torch.ops.scoring, kernel K2's plain version)
against the JAX package's XLA scoring and its Pallas kernel in interpret
mode, on the CPU, with the same inputs.

Tolerances.  Against XLA: 1e-5, float32 rounding (the port sums the groups
in ascending order; XLA reduces them in its own order) — both use arccos.
Against Pallas: 2e-4, the bound tests/test_scoring_pallas.py holds Pallas
to against XLA, because the Pallas kernel's polynomial acos errs by up to
6.7e-5 rad; its |cos| orientation gate is the same window.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from line3dpp_tpu.ops import scoring as jax_scoring
from line3dpp_tpu.ops import scoring_pallas
from line3dpp_tpu_torch.ops import scoring

from test_torch_scenes import agreeing_scoring_case, k2_arguments


def _port(case, k, orientation=True, chunk=64):
    out = scoring.score_matches(
        *(torch.from_numpy(case[n]) for n in (
            "r1", "r2", "rmid", "C", "k_reg", "neighbor_ids", "d_p1",
            "d_p2", "valid")),
        knn=k, two_sig_a_sqr=200.0, min_similarity=0.5,
        check_orientation=orientation, chunk=chunk)
    return out.score3d.numpy(), out.valid.numpy()


def _jax_args(case):
    return [jnp.asarray(case[n]) for n in (
        "r1", "r2", "rmid", "C", "k_reg", "neighbor_ids", "d_p1", "d_p2",
        "valid")]


@pytest.mark.parametrize("orientation", [True, False])
def test_plain_matches_xla(rng, orientation):
    case, k = agreeing_scoring_case(rng)
    want = jax_scoring.score_matches(
        *_jax_args(case), knn=k, two_sig_a_sqr=200.0, min_similarity=0.5,
        check_orientation=orientation, chunk=32)
    score, ok = _port(case, k, orientation)
    np.testing.assert_array_equal(ok, np.asarray(want.valid))
    assert (score > 0).sum() > 100
    np.testing.assert_allclose(score, np.asarray(want.score3d), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_pallas_interpret(rng):
    case, k = agreeing_scoring_case(rng)
    want = scoring_pallas.score_matches_pallas(
        *_jax_args(case), knn=k, two_sig_a_sqr=200.0, min_similarity=0.5,
        check_orientation=True, seg_tile=16, interpret=True)
    score, ok = _port(case, k)
    np.testing.assert_array_equal(ok, np.asarray(want.valid))
    np.testing.assert_allclose(score, np.asarray(want.score3d), rtol=2e-4,
                               atol=2e-4)


def test_chunking_does_not_change_results(rng):
    case, k = agreeing_scoring_case(rng, V=3, S=30)
    a = _port(case, k, chunk=7)
    b = _port(case, k, chunk=1000)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_own_group_never_scores(rng):
    """A slot is only confirmed by other cameras: with a single neighbour
    group every score is 0."""
    case, k = agreeing_scoring_case(rng, N=1, k=6)
    case["neighbor_ids"] = case["neighbor_ids"][:, :1]
    score, ok = _port(case, k)
    assert ok.any()
    assert not score.any()


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(rng):
    case, k = agreeing_scoring_case(rng, V=2, S=4, N=2, k=3)
    args = k2_arguments(case)
    with pytest.raises(ValueError, match="N\\*knn"):
        scoring.score_matches_cuda(*args, knn=k + 1, two_sig_a_sqr=200.0)
    with pytest.raises(ValueError, match="CUDA"):
        scoring.score_matches_cuda(*args, knn=k, two_sig_a_sqr=200.0)
