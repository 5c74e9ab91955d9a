"""K2, 3D hypothesis scoring (``ops/scoring.score_matches``): for each
segment, every ordered pair of its scored slots (valid after the
orientation gate) that lie in different neighbour groups, 40 float32
operations a pair (the direction's dot product, acos, three exponentials,
two divisions, the minima and maxima); the rays, cameras and validity read
once, the two depths of each valid slot read once, the score and its
validity written once."""

import numpy as np

OPS_PER_PAIR = 40


def pairs(score_valid: np.ndarray, N: int, knn: int) -> int:
    V, S, M = score_valid.shape
    per_group = score_valid.reshape(V, S, N, knn).sum(-1).astype(np.int64)
    total = per_group.sum(-1)
    return int((total * total - (per_group * per_group).sum(-1)).sum())


def count(x: dict) -> tuple[float, float]:
    V, S, M, N = x["V"], x["S"], x["M"], x["N"]
    sv = x["score_valid"]
    read = V * S * 3 * 12 + V * (12 + 4) + V * N * (12 + 4) + V * S * M
    read += 8 * int(sv.sum())
    written = V * S * M * (4 + 1)
    return float(OPS_PER_PAIR * pairs(sv, N, x["knn"])), float(read + written)
