"""Host milliseconds of one Levenberg-Marquardt iteration of line
bundling: the summed durations of the program's
``recon.bundle.lm_iteration`` spans over their count, in the traced
scenes: the host's time to launch an iteration's work, and to wait for
the card where the iteration reads from it."""

from l3dbench import spans


def read(ctx):
    recs = spans.records(ctx)
    its = spans.named(recs, "recon.bundle.lm_iteration") if recs else []
    if not its:
        return None
    return sum(spans.ms(s) for s in its) / len(its)
