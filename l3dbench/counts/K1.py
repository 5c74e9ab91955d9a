"""K1, epipolar matching (``ops/matching.match_pairs``): every source
segment of a valid view pair against every target segment of its neighbour
view, 36 float32 operations a candidate (4 epipolar dot products, 2
divisions, the overlap test); the segments, cameras and fundamental
matrices read once, the (pair, segment, k) table of every neighbour slot
written once: 6 four-byte fields (target, overlap, 4 depths) and the
validity."""

import numpy as np

OPS_PER_CANDIDATE = 36


def count(x: dict) -> tuple[float, float]:
    n_valid = x["mask"].sum(1).astype(np.int64)           # (V,)
    nbr, pv = x["neighbor_ids"], x["pair_valid"]
    candidates = int((n_valid[:, None] * n_valid[nbr] * pv).sum())
    V, S, N = x["V"], x["S"], x["N"]
    read = V * S * (16 + 1) + V * (36 + 12 + 4) + V * N * (36 + 4 + 1)
    written = V * N * S * x["knn"] * 25
    return float(OPS_PER_CANDIDATE * candidates), float(read + written)
