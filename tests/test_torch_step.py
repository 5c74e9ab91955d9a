"""Port forward step (line3dpp_tpu_torch.models.step) against JAX
``forward_step`` (XLA path) on the CPU: all 12 StepOutputs fields.

Synthetic scene: well conditioned; held exactly in every mask and index,
to relative 1e-3 in depth-derived fields and to 5e-3 in scores and
weights — the epipolar intersection parameters differ from XLA's in float32
rounding (see test_torch_matching.py), the differences reach the depths
(measured up to 8e-4 relative) and the similarities built on them (up to
3.3e-3 in an affinity weight).

Bundled 6-view subset (views 0-5, 800 segments, 4 neighbours, k = 10): the
same rounding differences flip a few near-threshold candidates, and each
flip changes a score by a whole thresholded similarity (>= 0.5).  Measured
here: 0 of 133,938 valid matches differ, 3 target indices (near-tied
overlaps), 3,395 scores by more than 1e-4, 4 of 962 estimates, 6 of 1,251
affinity edges.  The bounds below are 2-3x those counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from line3dpp_tpu.models import step as jax_step
from line3dpp_tpu_torch.models import step
from line3dpp_tpu_torch.models.pipeline import STEP_ARRAYS

from test_torch_scenes import STEP_KW, bundled_step_inputs, \
    synthetic_step_inputs


def _both(inp, **kw):
    args = [inp[n] for n in STEP_ARRAYS]
    got = step.forward_step(*(torch.from_numpy(a) for a in args), **kw)
    want = jax_step.forward_step(*(jnp.asarray(a) for a in args), **kw)
    return ({n: getattr(got, n).numpy() for n in got._fields},
            {n: np.asarray(getattr(want, n)) for n in want._fields})


@pytest.mark.parametrize("seed", [0, 7])
def test_forward_step_synthetic_all_fields(seed):
    inp = synthetic_step_inputs(seed=seed, V=6, S=48, N=4)
    got, want = _both(inp, **STEP_KW)
    assert set(got) == set(want) and len(got) == 12
    mv = want["match_valid"]
    assert want["est_valid"].sum() > 40 and want["aff_valid"].sum() > 40
    for n in ("match_valid", "kept", "est_valid", "aff_valid"):
        np.testing.assert_array_equal(got[n], want[n], n)
    np.testing.assert_array_equal(got["tgt_seg"][mv], want["tgt_seg"][mv])
    for n in ("score3d", "aff_weight"):
        np.testing.assert_allclose(got[n], want[n], atol=5e-3, err_msg=n)
    for n in ("est_P1", "est_P2", "est_d1", "est_d2", "median_depth"):
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3, atol=1e-4,
                                   err_msg=n)


def test_forward_step_bundled_subset_all_fields():
    inp = bundled_step_inputs(list(range(6)), max_line_segments=800,
                              num_neighbors=4)
    kw = dict(STEP_KW, knn=inp["knn"])
    got, want = _both(inp, **kw)
    mv = want["match_valid"]
    n_valid = int(mv.sum())
    assert n_valid > 100_000
    assert (got["match_valid"] != mv).sum() <= 0.001 * n_valid
    both = mv & got["match_valid"]
    assert (got["tgt_seg"] != want["tgt_seg"])[both].sum() <= 10
    dscore = np.abs(got["score3d"] - want["score3d"])
    assert (dscore > 1e-4).sum() <= 0.06 * n_valid
    assert np.median(dscore[both]) < 1e-5
    ev = want["est_valid"]
    assert (got["est_valid"] != ev).sum() <= 0.01 * ev.sum()
    ev = ev & got["est_valid"]
    for n in ("est_d1", "est_d2"):
        rel = np.abs(got[n] - want[n])[ev] / np.abs(want[n][ev])
        assert np.median(rel) < 1e-5 and np.mean(rel < 1e-3) > 0.97, n
    av = want["aff_valid"]
    assert (got["aff_valid"] != av).sum() <= 0.02 * av.sum()
    assert (got["kept"] != want["kept"]).sum() <= 0.02 * want["kept"].sum()
    np.testing.assert_allclose(got["median_depth"], want["median_depth"],
                               rtol=1e-2)


def test_median_positive_vs_jax(rng):
    x = rng.uniform(0.5, 9, (4, 11)).astype(np.float32)
    valid = rng.uniform(size=(4, 11)) < 0.5
    valid[3] = False                       # no valid entry -> EPS
    got = step._median_positive(torch.from_numpy(x), torch.from_numpy(valid))
    want = [np.asarray(jax_step._median_positive(jnp.asarray(a),
                                                 jnp.asarray(b)))
            for a, b in zip(x, valid)]
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_regroup_groups_match_slots_by_neighbour():
    V, N, S, k = 2, 3, 4, 5
    x = torch.arange(V * N * S * k).reshape(V * N, S, k)
    y = step.regroup(x, V, N)
    assert y.shape == (V, S, N * k)
    for v in range(V):
        for g in range(N):
            assert torch.equal(y[v, :, g * k:(g + 1) * k], x[v * N + g])
