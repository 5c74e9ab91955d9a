"""Host milliseconds of the reconstruction's own host stages per traced
scene: the summed durations of the program's spans ``recon.edges``,
``recon.dedup``, ``recon.cluster``, ``recon.fit``, ``recon.sweep`` and
``recon.assemble`` (siblings inside ``reconstruct_3d_lines``, none nested
in another), that is the reconstruction without bundling, collinearity
and RDD, averaged over the traced scenes."""

from l3dbench import spans

STAGES = ("recon.edges", "recon.dedup", "recon.cluster", "recon.fit",
          "recon.sweep", "recon.assemble")


def read(ctx):
    recs = spans.records(ctx)
    if not recs:
        return None
    per_scene = [sum(spans.ms(s) for name in STAGES
                     for s in spans.named([r], name)) for r in recs]
    if not any(per_scene):
        return None
    return sum(per_scene) / len(per_scene)
