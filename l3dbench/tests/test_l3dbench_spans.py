"""The readers of the program's own spans (``l3dbench/spans.py`` and the
metrics that use it): the clock offset, the busy share and the host times
on synthetic records and a synthetic trace; every reader silent where the
program keeps no spans; and a traced CPU run of each cell reporting its
span metrics, without the device's share, which has no device events to
read there."""

import sys
import types

import pytest

from l3dbench import registry, run, spans
from l3dbench.tests.conftest import tiny_cell
from l3dbench.trace import Trace

import line3dpp_tpu_torch
from line3dpp_tpu_torch import obs

OFFSET_US = -1.79e12 + 123.5
T0_NS = 1_790_000_000_000_000_000


def span(name, parent, start_us, end_us):
    """A program span from ``T0_NS``, times in microseconds."""
    s = obs.Span(name, parent, T0_NS + int(start_us * 1000))
    s.end = T0_NS + int(end_us * 1000)
    return s


def record(at_us, bundle_us=1000.0, iterations=4):
    """One scene's record from ``at_us``: reconstruct_3d_lines 0-3000 us,
    its six host stages 100 us each, collinearity 200 us, and bundling
    1000-2000 us with ``iterations`` LM iterations of 200 us."""
    s = [span("reconstruct_3d_lines", -1, at_us, at_us + 3000)]
    for k, name in enumerate(("recon.edges", "recon.dedup", "recon.cluster",
                              "recon.fit", "recon.sweep", "recon.assemble")):
        s.append(span(name, 0, at_us + 100 * k, at_us + 100 * (k + 1)))
    s.append(span("recon.collinearity", 0, at_us + 600, at_us + 800))
    s.append(span("recon.bundle", 0, at_us + bundle_us,
                  at_us + bundle_us + 1000))
    b = len(s) - 1
    for k in range(iterations):
        a = at_us + bundle_us + 200 * k
        s.append(span("recon.bundle.lm_iteration", b, a, a + 200))
    return types.SimpleNamespace(spans=s)


def bench_span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=f"l3dbench.{name}",
                ts=ts, dur=dur)


def kernel(ts, dur, cat="kernel"):
    return dict(ph="X", cat=cat, name="k", ts=ts, dur=dur,
                args=dict(correlation=0))


def ctx_for(recs, anchor_shift_us=(0.0, 0.0), device=()):
    """Two scenes at 0 and 10,000 us of the program's clock; the
    benchmark's anchors 40 us before the program's, each moved by its
    ``anchor_shift_us``; ``device`` events in program microseconds."""
    on_trace = lambda us: 1e-3 * T0_NS + us + OFFSET_US  # noqa: E731
    events = [bench_span("window", on_trace(-100), 30000)]
    for at, shift in zip((0.0, 10000.0), anchor_shift_us):
        events.append(bench_span("reconstruct_3d_lines",
                                 on_trace(at - 40 + shift), 3100))
    events += [kernel(on_trace(a), d, *cat) for a, d, *cat in device]
    scenes = [dict(views=26, phases={}) for _ in recs]
    return dict(scenes=scenes, trace=Trace(events), counts=[], peaks=None)


@pytest.fixture
def two_scenes(monkeypatch):
    recs = [record(0.0), record(10000.0, iterations=6)]
    monkeypatch.setattr(obs, "records", lambda: [record(-5e4)] + recs)
    return recs


def metric(name, ctx):
    return registry.metric(name).read(ctx)


def test_a_known_offset_is_recovered(two_scenes):
    ctx = ctx_for(two_scenes)
    recs = spans.records(ctx)
    assert recs == two_scenes
    assert spans.offset_us(ctx, recs) == pytest.approx(OFFSET_US - 40,
                                                       abs=0.5)


def test_an_anchor_past_two_ms_gives_no_offset(two_scenes):
    device = [(1500.0, 100.0)]
    ctx = ctx_for(two_scenes, anchor_shift_us=(0.0, 4500.0), device=device)
    assert spans.offset_us(ctx, spans.records(ctx)) is None
    assert metric("bundle.device_busy_share", ctx) is None
    ok = ctx_for(two_scenes, anchor_shift_us=(0.0, 1500.0), device=device)
    assert spans.offset_us(ok, spans.records(ok)) is not None


def test_the_busy_share_from_known_kernel_intervals(two_scenes):
    # the bundle spans, 1000-2000 and 11000-12000 us of the program's
    # clock, lie at 960-1960 and 10960-11960 of the events' (the anchors
    # open 40 us before the program's spans): two overlapping kernels
    # 1080-1380 (300 us), a copy at 11580-11680, a memset at 2480-2580
    # outside both, a kernel over scene 1's end (11910-12010: 50 us in)
    device = [(1080.0, 200.0), (1180.0, 200.0),
              (11580.0, 100.0, "gpu_memcpy"), (2480.0, 100.0, "gpu_memset"),
              (11910.0, 100.0)]
    ctx = ctx_for(two_scenes, device=device)
    value = metric("bundle.device_busy_share", ctx)
    # float64 microseconds of the Unix epoch resolve 0.25 us
    assert value == pytest.approx(100.0 * (300 + 100 + 50) / 2000, abs=0.05)


def test_the_host_times_of_known_spans(two_scenes):
    ctx = ctx_for(two_scenes)
    assert metric("recon.host_stages_ms", ctx) == pytest.approx(0.6)
    assert metric("bundle.lm_iteration_ms", ctx) == pytest.approx(0.2)
    assert metric("recon.collinearity_ms", ctx) == pytest.approx(0.2)
    assert metric("bundle.device_busy_share", ctx) is None   # no events


@pytest.mark.parametrize("name", ["recon.host_stages_ms",
                                  "bundle.lm_iteration_ms",
                                  "bundle.device_busy_share",
                                  "recon.collinearity_ms"])
def test_every_reader_is_silent_without_the_programs_spans(
        monkeypatch, two_scenes, name):
    ctx = ctx_for(two_scenes, device=[(1080.0, 200.0)])
    assert metric(name, ctx) is not None
    # fewer records than traced scenes
    monkeypatch.setattr(obs, "records", lambda: two_scenes[:1])
    assert metric(name, ctx) is None
    # a program without line3dpp_tpu_torch.obs, as before it had spans
    monkeypatch.setattr(obs, "records", lambda: two_scenes)
    monkeypatch.setitem(sys.modules, "line3dpp_tpu_torch.obs", None)
    monkeypatch.delattr(line3dpp_tpu_torch, "obs")
    assert metric(name, ctx) is None


@pytest.mark.parametrize("name", [w["name"]
                                  for w in registry.benchmark()["workloads"]])
def test_a_traced_cpu_run_reports_the_span_metrics_of_its_cell(name):
    obs.clear()
    res = run.run_cell(tiny_cell(name), 2**31 + 11, 10.0, True, "cpu")
    assert res["correct"], res["checks"]
    listed = {m["name"] for m in registry.cell(name)["per_layer"]}
    want = listed & {"recon.host_stages_ms", "bundle.lm_iteration_ms",
                     "recon.collinearity_ms"}
    assert "recon.host_stages_ms" in want
    assert want <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] > 0 for m in want)
    assert "bundle.device_busy_share" not in res["metrics"]
