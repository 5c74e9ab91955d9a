"""Port matcher (line3dpp_tpu_torch.ops.matching, kernel K1's plain version)
against the JAX package's XLA matcher and its Pallas kernel in interpret
mode, on the CPU.

Tolerances.  The epipolar parameters t = -(e.q1h)/(e.dqh) cancel large
terms, so float32 rounding differences between XLA's K=3 matmuls and the
port's written-out sums grow to 3.5e-5 in the overlap on the synthetic
scene (6e-4 on bundled views) and to a few percent in depths whose
plane-ray denominator is near zero.  A candidate whose overlap lies that
close to ``epipolar_overlap`` or to a neighbour's overlap may therefore
change sides.  The synthetic scenes must agree exactly in the selected
matches; on real segments the share of differing slots is bounded and
stated per test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from line3dpp_tpu.ops import matching as jax_matching
from line3dpp_tpu.ops import matching_pallas
from line3dpp_tpu_torch.ops import matching

from test_torch_scenes import bundled_step_inputs, pair_list, \
    synthetic_step_inputs

KNN = 4


def _args(inp):
    src, tgt, F, pv = pair_list(inp)
    return (inp["segments"], inp["seg_mask"], inp["RtKinv"], inp["C"],
            src, tgt, F, pv)


def _port(inp, knn, chunk=3):
    out = matching.match_pairs(*(torch.from_numpy(a) for a in _args(inp)),
                               0.25, knn, chunk=chunk)
    return {k: v.numpy() for k, v in out._asdict().items()}


def _jax(inp, knn):
    out = jax_matching.match_pairs_chunked(
        *(jnp.asarray(a) for a in _args(inp)), 0.25, knn, chunk=4)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _pallas(inp, knn):
    out = matching_pallas.match_pairs_pallas(
        *(jnp.asarray(a) for a in _args(inp)), epipolar_overlap=0.25,
        knn=knn, row_tile=32, interpret=True)
    # (P, k, S) -> (P, S, k)
    return {k: np.asarray(v).transpose(0, 2, 1)
            for k, v in out._asdict().items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla_on_synthetic_scene(seed):
    inp = synthetic_step_inputs(seed=seed)
    got, want = _port(inp, KNN), _jax(inp, KNN)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() > 50
    np.testing.assert_array_equal(got["tgt_seg"][v], want["tgt_seg"][v])
    np.testing.assert_array_equal(got["tgt_seg"][~v], 0)
    np.testing.assert_allclose(got["overlap"], want["overlap"], atol=1e-4)
    for d in ("d_p1", "d_p2", "d_q1", "d_q2"):
        np.testing.assert_allclose(got[d], want[d], rtol=1e-3, atol=1e-5)


def test_plain_matches_pallas_interpret_on_synthetic_scene():
    """Same selection as the Pallas kernel, including its idx 0 / zeros at
    invalid slots."""
    inp = synthetic_step_inputs(seed=2)
    got, want = _port(inp, KNN), _pallas(inp, KNN)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["tgt_seg"], want["tgt_seg"])
    np.testing.assert_allclose(got["overlap"], want["overlap"], atol=1e-4)
    for d in ("d_p1", "d_p2", "d_q1", "d_q2"):
        np.testing.assert_allclose(got[d], want[d], rtol=1e-3, atol=1e-5)


def test_plain_matches_xla_on_bundled_views():
    """3 bundled views capped at 300 segments, k = 10."""
    inp = bundled_step_inputs([0, 1, 2], max_line_segments=300,
                              num_neighbors=2)
    got, want = _port(inp, 10), _jax(inp, 10)
    v = want["valid"]
    n = int(v.sum())
    assert n > 1000
    # membership of the selected set may flip for near-threshold or
    # near-tied candidates (module docstring): at most 0.5% of slots
    assert (got["valid"] != v).sum() <= 0.005 * n
    same = v & got["valid"] & (got["tgt_seg"] == want["tgt_seg"])
    assert same.sum() >= 0.99 * n
    np.testing.assert_allclose(got["overlap"][same], want["overlap"][same],
                               atol=1e-4)
    # depths: 99.9% within 1e-3 relative; the rest are near-grazing rays
    for d in ("d_p1", "d_p2", "d_q1", "d_q2"):
        rel = np.abs(got[d][same] - want[d][same]) / np.maximum(
            np.abs(want[d][same]), 1e-6)
        assert np.quantile(rel, 0.999) < 1e-3, d


def test_ties_go_to_the_lowest_target_index():
    """Duplicated target segments give equal overlaps; the lower index must
    come first, as with lax.top_k."""
    inp = synthetic_step_inputs(seed=4, S=64, n_lines=20)
    segs, mask = inp["segments"], inp["seg_mask"]
    segs[:, 20:40] = segs[:, 0:20]          # every line twice
    mask[:, 20:40] = True
    got, want = _port(inp, KNN), _jax(inp, KNN)
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["tgt_seg"][v], want["tgt_seg"][v])
    first, second = got["tgt_seg"][..., 0], got["tgt_seg"][..., 1]
    dup = v[..., 1] & (second == first + 20)
    assert dup.sum() > 20


def test_chunking_does_not_change_results():
    inp = synthetic_step_inputs(seed=5)
    a, b = _port(inp, KNN, chunk=1), _port(inp, KNN, chunk=100)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_invalid_pairs_and_rows_yield_no_matches():
    inp = synthetic_step_inputs(seed=6)
    inp["pair_valid"][0, :] = False
    inp["seg_mask"][1, :10] = False
    got = _port(inp, KNN)
    N = inp["neighbor_ids"].shape[1]
    assert not got["valid"][:N].any()
    assert not got["valid"][N:2 * N, :10].any()
    for k in ("tgt_seg", "overlap", "d_p1", "d_p2", "d_q1", "d_q2"):
        assert not got[k][:N].any()


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    t = matching.pair_tables(
        *(torch.from_numpy(a) for a in _args(synthetic_step_inputs())))
    with pytest.raises(ValueError, match="knn"):
        matching.match_pairs_cuda(t, 0.25, t.mask.shape[1] + 1)
    with pytest.raises(ValueError, match="knn"):
        matching.match_pairs_cuda(t, 0.25, 0)
    with pytest.raises(ValueError, match="CUDA"):
        matching.match_pairs_cuda(t, 0.25, KNN)
