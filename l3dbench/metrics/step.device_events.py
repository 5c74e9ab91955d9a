"""Device events (kernels, copies, memsets) launched inside
``Line3D.match_images`` per scene."""


def read(ctx):
    n = sum(1 for s in ctx["scenes"] if "match_images" in s["phases"])
    if not n:
        return None
    return len(ctx["trace"].device_in("match_images")) / n
