"""K1-K3's share of their roofline in the traced window, in %: the sum
over the traced scenes of each kernel's bound, max(operations / peak
float32 rate, bytes / peak bandwidth), with the operations and bytes that
``l3dbench/counts/K1.py``, ``K2.py`` and ``K3.py`` count on each scene's
inputs, over the sum of the card's time in those kernels (by kernel name,
launched inside ``Line3D.match_images``)."""

import re

from l3dbench import registry

KERNELS = {
    "K1": re.compile(r"\bmatch_(kernel|list_kernel|all_kernel)\b"),
    "K2": re.compile(r"\bscore_(kernel|all_kernel|overflow_kernel)\b"),
    "K3": re.compile(r"\bgather_kernel\b"),
}


def read(ctx):
    peaks = ctx.get("peaks")
    if not peaks or not ctx.get("counts"):
        return None
    events = ctx["trace"].device_in("match_images")
    device_us = sum(e["dur"] for e in events if e.get("cat") == "kernel"
                    and any(p.search(e["name"]) for p in KERNELS.values()))
    if device_us <= 0:
        return None
    bound_s = 0.0
    for counts in ctx["counts"]:
        for name in KERNELS:
            ops, moved = registry.kernel_count(name).count(counts)
            bound_s += max(ops / peaks["f32_ops_per_s"],
                           moved / peaks["bytes_per_s"])
    return 100.0 * bound_s / (1e-6 * device_us)
