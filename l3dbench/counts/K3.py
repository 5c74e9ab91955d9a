"""K3, the affinity stage's gather of target estimates
(``ops/affinity.gather_target_estimates``): the (V, S, 8) estimate table,
the estimate validity, the neighbour table and the (V, S, M) target
segments read once, the gathered 8 floats and validity of every slot
written once; no arithmetic to speak of."""


def count(x: dict) -> tuple[float, float]:
    V, S, M, N = x["V"], x["S"], x["M"], x["N"]
    read = V * S * 32 + V * S + V * N * 4 + V * S * M * 4
    written = V * S * M * (32 + 1)
    return 0.0, float(read + written)
