"""The program's own spans (``line3dpp_tpu_torch.obs``) of the traced
scenes, and the offset that puts them on the trace's clock.

The program keeps one record of spans per ``Line3D``, each span with its
name, its parent and its start and end from ``time.time_ns()``; the
profiler's chrome trace counts microseconds from a base of its own, which
``l3dbench.trace.Trace`` does not keep.  The offset between the two clocks
is recovered from each traced scene's pair of spans that open together:
the benchmark's ``l3dbench.reconstruct_3d_lines`` and the program's
``reconstruct_3d_lines`` just inside it.  With a program that keeps no
spans (``line3dpp_tpu_torch.obs`` missing), every reader here returns
None.
"""

from __future__ import annotations

import statistics

ANCHOR = "reconstruct_3d_lines"
# the most a scene's anchor may lie from the run's median offset, in us
ANCHOR_SPREAD_US = 2000.0


def records(ctx):
    """The program's records of the traced scenes, in the scenes' order
    (the last ``len(ctx["scenes"])`` records the program kept), or None
    where it kept fewer, or none."""
    try:
        from line3dpp_tpu_torch import obs
    except ImportError:
        return None
    n = len(ctx["scenes"])
    recs = obs.records()
    if n == 0 or len(recs) < n:
        return None
    return recs[-n:]


def named(recs, name: str) -> list:
    """The closed spans called ``name`` of every record in ``recs``."""
    return [s for r in recs for s in r.spans
            if s.name == name and s.end is not None]


def ms(span) -> float:
    return 1e-6 * (span.end - span.start)


def anchors_us(ctx, recs):
    """Per scene, the benchmark's anchor span's start on the trace less
    the program's anchor span's start, in microseconds; None where a scene
    lacks either."""
    bench = sorted(s["ts"] for s in ctx["trace"].spans_named(ANCHOR))
    if len(bench) != len(recs):
        return None
    out = []
    for ts, rec in zip(bench, recs):
        prog = next((s for s in rec.spans
                     if s.name == ANCHOR and s.parent < 0), None)
        if prog is None:
            return None
        out.append(ts - 1e-3 * prog.start)
    return out


def offset_us(ctx, recs):
    """The run's offset from the program's clock (``time.time_ns()`` in
    microseconds) to the trace's: the median of the scenes' anchors, or
    None where any anchor lies more than ``ANCHOR_SPREAD_US`` from it."""
    d = anchors_us(ctx, recs) if recs else None
    if not d:
        return None
    med = statistics.median(d)
    if any(abs(x - med) > ANCHOR_SPREAD_US for x in d):
        return None
    return med


def on_trace(span, offset: float) -> tuple[float, float]:
    """A program span's (start, end) on the trace, in microseconds."""
    return 1e-3 * span.start + offset, 1e-3 * span.end + offset
