"""Host milliseconds of ``Line3D.match_images`` (``models/step``) per
scene, after a synchronize."""

from l3dbench.metrics import phase_ms


def read(ctx):
    return phase_ms(ctx, "match_images")
