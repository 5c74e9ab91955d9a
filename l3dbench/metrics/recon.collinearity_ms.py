"""Host milliseconds of the collinearity stage per call: the mean
duration of the program's ``recon.collinearity`` spans in the traced
scenes.  The stage ends in its host copy of the edges, so its device
time is inside."""

from l3dbench import spans


def read(ctx):
    recs = spans.records(ctx)
    calls = spans.named(recs, "recon.collinearity") if recs else []
    if not calls:
        return None
    return sum(spans.ms(s) for s in calls) / len(calls)
