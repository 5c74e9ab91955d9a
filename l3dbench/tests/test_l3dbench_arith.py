"""The metric arithmetic: the rate and the tail of a window, the idle
share and the breakdown from synthetic trace events, and the roofline
from known counts."""

import pytest

from l3dbench import registry, run
from l3dbench.trace import Trace, gaps_us, union_us


def span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=f"l3dbench.{name}",
                ts=ts, dur=dur)


def launch(corr, ts):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=1, args=dict(correlation=corr))


def kernel(name, corr, ts, dur, cat="kernel"):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                args=dict(correlation=corr))


def synthetic_trace():
    """A 1000 us window: match_images 0-400 launches two step kernels
    (100 us and 50 us, overlapping by 20) and a DtoH copy;
    reconstruct_3d_lines 400-900 launches one kernel and two DtoH
    copies."""
    return Trace([
        span("window", 0, 1000), span("match_images", 0, 400),
        span("reconstruct_3d_lines", 400, 500),
        launch(1, 10), kernel("void match_kernel<10>(float4 const*)", 1,
                              20, 100),
        launch(2, 30), kernel("score_kernel", 2, 100, 50),
        launch(3, 40), kernel("Memcpy DtoH (Device -> Pinned)", 3, 300, 10,
                              "gpu_memcpy"),
        launch(4, 450), kernel("cc_kernel", 4, 500, 100),
        launch(5, 460), kernel("Memcpy DtoH (Device -> Pageable)", 5, 700,
                               5, "gpu_memcpy"),
        launch(6, 470), kernel("Memcpy DtoH (Device -> Pageable)", 6, 800,
                               5, "gpu_memcpy"),
        dict(ph="X", cat="cpu_op", name="aten::nonzero", ts=610, dur=80),
    ])


def ctx(**kw):
    scenes = [dict(views=2, phases={"match_images": 0.4,
                                    "reconstruct_3d_lines": 0.5})]
    return dict(dict(scenes=scenes, trace=synthetic_trace(), counts=[],
                     peaks=None), **kw)


def test_union_and_gaps_of_intervals():
    assert union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert union_us([(0, 10), (5, 20)], lo=8, hi=12) == 4
    assert gaps_us([(10, 20), (15, 30)], 0, 50) == [(0, 10), (30, 50)]


def test_idle_share_from_synthetic_events():
    # busy: 20-150 (130), 300-310, 500-600, 700-705, 800-805 = 250 us
    value = registry.metric("device.idle_share").read(ctx())
    assert value == pytest.approx(75.0)


def test_events_and_host_times_by_span():
    c = ctx()
    assert registry.metric("step.device_events").read(c) == 3
    assert registry.metric("step.match_ms").read(c) == pytest.approx(400)
    assert registry.metric("recon.reconstruct_ms").read(c) == pytest.approx(
        500)
    c["scenes"] = [dict(views=2, phases={})]
    assert registry.metric("recon.reconstruct_ms").read(c) is None


def test_breakdown_names_the_host_work_of_each_gap():
    tr = synthetic_trace()
    gaps = dict(tr.idle_gaps())
    assert gaps["reconstruct_3d_lines: aten::nonzero"] == pytest.approx(
        100e-6)
    assert gaps["reconstruct_3d_lines: python"] == pytest.approx(285e-6)
    ops = dict(tr.device_ops())
    assert ops["cc_kernel"] == pytest.approx(100e-6)
    assert ops["score_kernel"] == pytest.approx(50e-6)


def test_roofline_from_known_counts(monkeypatch):
    counts = {"K1": (67e6, 0.0), "K2": (0.0, 3.35e5), "K3": (0.0, 0.0)}

    class Fake:
        def __init__(self, k):
            self.k = k

        def count(self, x):
            return counts[self.k]

    monkeypatch.setattr(registry, "kernel_count", Fake)
    peaks = dict(f32_ops_per_s=67e12, bytes_per_s=3.35e12)
    # bounds 1 us + 0.1 us over 150 us of K1/K2 time in match_images
    value = registry.metric("kernels.step_roofline").read(
        ctx(counts=[{}], peaks=peaks))
    assert value == pytest.approx(100 * 1.1 / 150)
    assert registry.metric("kernels.step_roofline").read(ctx()) is None


def test_rate_and_tail_of_a_window():
    times = [0.1 * (i + 1) for i in range(20)]
    assert run.p90(times) == pytest.approx(1.81)
