"""Port affinity stage (line3dpp_tpu_torch.ops.affinity: filtering, kernel
K3's plain target gather, dense affinity, edge compaction) against the JAX
package on the CPU, with the same inputs.

The gather is bit-exact against XLA's advanced indexing and against the
Pallas one-hot gather in interpret mode (whose d1 is defined only where the
target estimate is valid: it encodes invalid estimates as d1 = -1).  The
similarity math is float32 elementwise work in the same order as JAX; it
is held to 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from line3dpp_tpu.ops import affinity as jax_affinity
from line3dpp_tpu.ops import affinity_pallas
from line3dpp_tpu_torch.ops import affinity


def _estimates(rng, V=4, S=40, N=3, k=5):
    est_P1 = rng.normal(size=(V, S, 3)).astype(np.float32)
    return dict(
        est_P1=est_P1,
        est_P2=(est_P1 + rng.normal(size=(V, S, 3))).astype(np.float32),
        est_d1=rng.uniform(1.0, 9.0, (V, S)).astype(np.float32),
        est_d2=rng.uniform(1.0, 9.0, (V, S)).astype(np.float32),
        est_valid=rng.uniform(size=(V, S)) < 0.7,
        neighbor_ids=np.stack([rng.permutation(V)[:N]
                               for _ in range(V)]).astype(np.int32),
        tgt_seg=rng.integers(0, S, (V, S, N * k)).astype(np.int32)), k


_GATHER_ARGS = ("est_P1", "est_P2", "est_d1", "est_d2", "est_valid",
                "neighbor_ids", "tgt_seg")


def _port_gather(e, k):
    g = affinity.gather_target_estimates(
        *(torch.from_numpy(e[n]) for n in _GATHER_ARGS), k)
    return ([x.numpy() for x in g.P1], [x.numpy() for x in g.P2],
            g.d1.numpy(), g.d2.numpy(), g.valid.numpy())


def test_gather_bit_exact_vs_xla_indexing(rng):
    e, k = _estimates(rng)
    P1, P2, d1, d2, valid = _port_gather(e, k)
    V, S, M = e["tgt_seg"].shape
    tview = jnp.broadcast_to(
        jnp.repeat(jnp.asarray(e["neighbor_ids"]), k, axis=1)[:, None, :],
        (V, S, M))
    ts = jnp.asarray(e["tgt_seg"])
    g = lambda x: np.asarray(jnp.asarray(x)[tview, ts])   # affinity.py:264
    for i in range(3):
        np.testing.assert_array_equal(P1[i], g(e["est_P1"][..., i]))
        np.testing.assert_array_equal(P2[i], g(e["est_P2"][..., i]))
    np.testing.assert_array_equal(d1, g(e["est_d1"]))
    np.testing.assert_array_equal(d2, g(e["est_d2"]))
    np.testing.assert_array_equal(valid, g(e["est_valid"]))


def test_gather_bit_exact_vs_pallas_interpret(rng):
    e, k = _estimates(rng, V=5, S=30, N=2, k=4)
    e["est_d1"][:, 0] = 0.0          # a valid zero depth stays valid
    e["est_valid"][:, 0] = True
    P1, P2, d1, d2, valid = _port_gather(e, k)
    want = affinity_pallas.gather_target_estimates(
        *(jnp.asarray(e[n]) for n in _GATHER_ARGS), k, interpret=True)
    for i in range(3):
        np.testing.assert_array_equal(P1[i], np.asarray(want[0][i]))
        np.testing.assert_array_equal(P2[i], np.asarray(want[1][i]))
    np.testing.assert_array_equal(valid, np.asarray(want[4]))
    np.testing.assert_array_equal(d1[valid], np.asarray(want[2])[valid])
    np.testing.assert_array_equal(d2, np.asarray(want[3]))


def test_estimate_table_layout(rng):
    e, _ = _estimates(rng, V=2, S=5)
    tab = affinity.estimate_table(
        *(torch.from_numpy(e[n]) for n in _GATHER_ARGS[:4])).numpy()
    assert tab.shape == (2, 5, 8) and tab.flags.c_contiguous
    np.testing.assert_array_equal(tab[..., 0:3], e["est_P1"])
    np.testing.assert_array_equal(tab[..., 3:6], e["est_P2"])
    np.testing.assert_array_equal(tab[..., 6], e["est_d1"])
    np.testing.assert_array_equal(tab[..., 7], e["est_d2"])


def test_filter_matches_vs_jax(rng):
    V, S, M = 3, 50, 12
    r1 = rng.normal(size=(V, S, 3)).astype(np.float32)
    r2 = rng.normal(size=(V, S, 3)).astype(np.float32)
    C = rng.normal(size=(V, 3)).astype(np.float32)
    # quantised scores give ties, which argmax must break like jnp.argmax
    score = (rng.integers(0, 12, (V, S, M)) * 0.25).astype(np.float32)
    valid = rng.uniform(size=(V, S, M)) < 0.6
    d1 = rng.uniform(1, 9, (V, S, M)).astype(np.float32)
    d2 = rng.uniform(1, 9, (V, S, M)).astype(np.float32)
    args = (r1, r2, C, score, valid, d1, d2)
    got = affinity.filter_matches(*(torch.from_numpy(a) for a in args))
    want = jax_affinity.filter_matches(*(jnp.asarray(a) for a in args))
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("med_scene", [5.0, 0.0])
def test_affinity_dense_vs_jax(rng, med_scene):
    e, k = _estimates(rng)
    V, S, M = e["tgt_seg"].shape
    kept = rng.uniform(size=(V, S, M)) < 0.6
    k_reg = rng.uniform(0.001, 0.01, V).astype(np.float32)
    med = rng.uniform(3, 8, V).astype(np.float32)
    fm_np = dict(kept=kept, est_valid=e["est_valid"], est_P1=e["est_P1"],
                 est_P2=e["est_P2"], est_d1=e["est_d1"], est_d2=e["est_d2"],
                 max_score=np.ones(V, np.float32))

    got = affinity.affinity_dense(
        affinity.FilteredMatches(**{n: torch.from_numpy(v)
                                    for n, v in fm_np.items()}),
        torch.from_numpy(e["tgt_seg"]), torch.from_numpy(e["neighbor_ids"]),
        torch.from_numpy(k_reg), torch.from_numpy(med), med_scene, 200.0,
        0.5)
    want = jax_affinity.affinity_dense(
        jax_affinity.FilteredMatches(**{n: jnp.asarray(v)
                                        for n, v in fm_np.items()}),
        jnp.asarray(e["tgt_seg"]), jnp.asarray(e["neighbor_ids"]),
        jnp.asarray(k_reg), jnp.asarray(med), med_scene, 200.0, 0.5)
    np.testing.assert_array_equal(got.edge_valid.numpy(),
                                  np.asarray(want.edge_valid))
    assert got.edge_valid.sum() >= 5
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-6, atol=1e-6)


def test_compact_edges_row_major(rng):
    V, S, M = 3, 7, 6
    valid = rng.uniform(size=(V, S, M)) < 0.3
    weight = np.where(valid, rng.uniform(0.5, 1, (V, S, M)), 0).astype(
        np.float32)
    tgt = rng.integers(0, S, (V, S, M)).astype(np.int32)
    idx, w, ts = affinity.compact_edges(
        affinity.AffinityDense(torch.from_numpy(weight),
                               torch.from_numpy(valid)),
        torch.from_numpy(tgt))
    want = np.asarray(jnp.nonzero(jnp.asarray(valid).reshape(-1))[0])
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(w, weight.reshape(-1)[want])
    np.testing.assert_array_equal(ts, tgt.reshape(-1)[want])


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(rng):
    e, k = _estimates(rng, V=2, S=6, N=2, k=2)
    t = {n: torch.from_numpy(v) for n, v in e.items()}
    table = affinity.estimate_table(t["est_P1"], t["est_P2"], t["est_d1"],
                                    t["est_d2"])
    with pytest.raises(ValueError, match="N\\*knn"):
        affinity.gather_target_estimates_cuda(
            table, t["est_valid"], t["neighbor_ids"], t["tgt_seg"], k + 1)
    with pytest.raises(ValueError, match="CUDA"):
        affinity.gather_target_estimates_cuda(
            table, t["est_valid"], t["neighbor_ids"], t["tgt_seg"], k)
