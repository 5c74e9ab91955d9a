"""The share of the traced window in which no kernel, copy or memset ran
on the card: 1 - (union of device activity intervals) / window, in %."""


def read(ctx):
    lo, hi = ctx["trace"].window()
    if hi <= lo:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_us() / (hi - lo))
