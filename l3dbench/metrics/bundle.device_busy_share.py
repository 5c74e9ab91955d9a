"""The share of line bundling's time in which the card is busy, in %: the
program's ``recon.bundle`` spans moved onto the trace's clock (the offset
of ``l3dbench.spans``), the union of kernel, copy and memset intervals
clipped to each span, summed, over the spans' summed duration."""

from l3dbench import spans
from l3dbench.trace import union_us


def read(ctx):
    tr = ctx["trace"]
    recs = spans.records(ctx)
    if not tr.device or not recs:
        return None
    bundles = spans.named(recs, "recon.bundle")
    offset = spans.offset_us(ctx, recs)
    if not bundles or offset is None:
        return None
    device = [(e["ts"], e["ts"] + e["dur"]) for e in tr.device]
    busy = total = 0.0
    for s in bundles:
        lo, hi = spans.on_trace(s, offset)
        busy += union_us(device, lo, hi)
        total += hi - lo
    return 100.0 * busy / total if total > 0 else None
