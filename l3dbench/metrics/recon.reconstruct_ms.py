"""Host milliseconds of ``Line3D.reconstruct_3d_lines`` (clustering,
fitting, sweep, and where the cell runs them bundling, collinearity and
RDD) per scene, after a synchronize."""

from l3dbench.metrics import phase_ms


def read(ctx):
    return phase_ms(ctx, "reconstruct_3d_lines")
