"""The kernel counts at a tiny size against brute-force counts."""

import numpy as np
import pytest

from l3dbench import registry


def tiny(seed=0, V=4, S=7, N=3, knn=2):
    rng = np.random.default_rng(seed)
    mask = rng.random((V, S)) < 0.7
    nbr = np.stack([rng.choice([j for j in range(V) if j != i], N,
                               replace=False) for i in range(V)])
    pv = rng.random((V, N)) < 0.8
    sv = rng.random((V, S, N * knn)) < 0.5
    return dict(V=V, S=S, M=N * knn, N=N, knn=knn, mask=mask,
                neighbor_ids=nbr, pair_valid=pv, score_valid=sv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_candidates_brute_force(seed):
    x = tiny(seed)
    want = 0
    for i in range(x["V"]):
        for g in range(x["N"]):
            if not x["pair_valid"][i, g]:
                continue
            j = x["neighbor_ids"][i, g]
            for s in range(x["S"]):
                for t in range(x["S"]):
                    want += bool(x["mask"][i, s] and x["mask"][j, t])
    ops, _ = registry.kernel_count("K1").count(x)
    assert ops == 36 * want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2_pairs_brute_force(seed):
    x = tiny(seed)
    sv, knn = x["score_valid"], x["knn"]
    want = 0
    for v in range(x["V"]):
        for s in range(x["S"]):
            for m in range(x["M"]):
                for j in range(x["M"]):
                    want += bool(sv[v, s, m] and sv[v, s, j]
                                 and m // knn != j // knn)
    ops, moved = registry.kernel_count("K2").count(x)
    assert ops == 40 * want
    assert moved > 8 * sv.sum()


def test_k3_moves_its_tables_once():
    x = tiny()
    ops, moved = registry.kernel_count("K3").count(x)
    V, S, M, N = x["V"], x["S"], x["M"], x["N"]
    assert ops == 0
    assert moved == V * S * 33 + V * N * 4 + V * S * M * 37
