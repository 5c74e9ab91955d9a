"""Per-layer metrics: one module per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric, each with ``read(ctx)`` returning its
value, or None where the traced window holds nothing to read (the harness
then leaves the metric out).  ``ctx``: ``scenes`` (the traced scenes, each
with ``views`` and ``phases``, host seconds of each phase after a
synchronize), ``trace`` (``l3dbench.trace.Trace``), ``counts`` (each traced
scene's kernel counts from the reference), ``peaks`` (the card's row of
``l3dbench/peaks.json``, or None)."""


def phase_ms(ctx, phase: str):
    """Mean host milliseconds of ``phase`` over the traced scenes."""
    t = [s["phases"][phase] for s in ctx["scenes"] if phase in s["phases"]]
    return 1e3 * sum(t) / len(t) if t else None
