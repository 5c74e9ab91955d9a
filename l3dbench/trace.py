"""The traced window's profile, read into plain lists.

``torch.profiler`` records the CPU side and the card (CUPTI) while the
window's scenes run under the benchmark's own spans (``l3dbench.*``,
``torch.profiler.record_function``).  The trace is exported to a temporary
directory under ``TMPDIR``, read and deleted.  A device event (kernel,
copy or memset) belongs to a span when the runtime call that launched it
(same correlation id) lies inside the span.  Every device-to-host copy is
a host sync (``.item()``, ``int()``, ``nonzero``, ``.cpu()``), the
arithmetic of the repository's ``chip_smoke.py``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "l3dbench.window"


def union_us(intervals, lo=None, hi=None) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals,
    clipped to ``[lo, hi]`` where given."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def gaps_us(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """Spans, CPU ops, runtime calls and device events of one profile
    (chrome-trace microseconds)."""

    def __init__(self, events: list[dict]):
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.spans = [e for e in x if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith("l3dbench.")]
        self.cpu_ops = [e for e in x if e.get("cat") == "cpu_op"]
        self.device = [e for e in x if e.get("cat") in DEVICE_CATS]
        launch = {}
        for e in x:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launch[c] = e["ts"]
        self.launch_ts = launch

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return cls(events)

    def spans_named(self, name: str) -> list[dict]:
        return [s for s in self.spans if s["name"] == f"l3dbench.{name}"]

    def window(self) -> tuple[float, float]:
        w = self.spans_named("window")
        if not w:
            raise ValueError("the trace holds no l3dbench.window span")
        return w[0]["ts"], w[0]["ts"] + w[0]["dur"]

    def device_in(self, name: str) -> list[dict]:
        """The device events launched inside the spans ``l3dbench.<name>``."""
        spans = sorted((s["ts"], s["ts"] + s["dur"])
                       for s in self.spans_named(name))
        starts = [a for a, _ in spans]
        out = []
        for e in self.device:
            t = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= spans[k][1]:
                out.append(e)
        return out

    def busy_us(self) -> float:
        lo, hi = self.window()
        return union_us(((e["ts"], e["ts"] + e["dur"]) for e in self.device),
                        lo, hi)

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, by name, seconds."""
        by = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"]
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, 1e-6 * us] for name, us in rows]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The window's idle device time by what the host was doing: each
        gap between device events is named by the phase span and the
        innermost CPU op around its middle ("python" where none is), and
        the gaps are summed by name; the longest names, seconds."""
        lo, hi = self.window()
        gaps = gaps_us(((e["ts"], e["ts"] + e["dur"]) for e in self.device),
                       lo, hi)
        phases = sorted(((s["ts"], s["ts"] + s["dur"], s["name"][9:])
                         for s in self.spans
                         if s["name"] not in (WINDOW, "l3dbench.scene")))
        ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in self.cpu_ops)
        op_starts = [o[0] for o in ops]
        by = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            phase = next((p[2] for p in phases if p[0] <= mid <= p[1]),
                         "between scenes")
            op = "python"
            k = bisect.bisect_right(op_starts, mid)
            best = None
            for o in ops[max(0, k - 64):k]:
                if o[0] <= mid <= o[1] and (best is None or o[0] >= best[0]):
                    best = o
            if best is not None:
                op = best[2]
            name = f"{phase}: {op}"
            by[name] = by.get(name, 0.0) + (b - a)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, 1e-6 * us] for name, us in rows]
