"""The port's spans and counters (``line3dpp_tpu_torch.obs``), on the CPU.

Off (no profiler, outside ``obs.recording()``) a span is one shared null
context: nothing is recorded, no ``record_function`` is entered and no
clock is read.  On, spans nest by parent within one record per pipeline,
self time is the duration less the children's, and a kernel launch counts
both in ``kernels.LAUNCHES`` and in the innermost open span.  A small
scene with collinearity, RDD and bundling run under ``torch.profiler``
records every span of the path it takes, one ``recon.bundle.lm_iteration``
per LM iteration, each span as a ``user_annotation`` of the chrome trace
inside its parent's, stamped on the trace's clock: ``(start -
baseTimeNanoseconds) / 1000`` within 2 ms of the annotation's ``ts``, the
median within 0.2 ms.  The lines are bit-identical with recording on and
off.
"""

import json
import statistics
import types

import numpy as np
import pytest
import torch

import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch import obs
from line3dpp_tpu_torch.ops import kernels
from line3dpp_tpu_torch.utils import synthetic

ITERATIONS = 3
CONFIG = dict(num_neighbors=4, max_line_segments=64, optimize=True,
              collinearity_t=2.0, perform_rdd=True,
              max_iter_optim=ITERATIONS)
# the spans a cached scene with CONFIG reaches, each with its parent
CACHED = {
    "add_view": None, "match_images": None, "reconstruct_3d_lines": None,
    "step.inputs": "match_images", "step.match": "match_images",
    "step.score": "match_images", "step.filter": "match_images",
    "step.affinity": "match_images",
    "recon.edges": "reconstruct_3d_lines",
    "recon.collinearity": "reconstruct_3d_lines",
    "recon.dedup": "reconstruct_3d_lines",
    "recon.rdd": "reconstruct_3d_lines",
    "recon.cluster": "reconstruct_3d_lines",
    "recon.fit": "reconstruct_3d_lines",
    "recon.bundle": "reconstruct_3d_lines",
    "recon.bundle.lm_iteration": "recon.bundle",
    "recon.sweep": "reconstruct_3d_lines",
    "recon.assemble": "reconstruct_3d_lines",
}


@pytest.fixture(autouse=True)
def fresh_records():
    obs.clear()
    yield
    obs.clear()


class Owner:
    """A stand-in for a pipeline: anything a weak reference can hold."""


class FakeClock:
    """``time.time_ns`` that moves only when told."""

    def __init__(self):
        self.now = 0
        self.reads = 0

    def time_ns(self):
        self.reads += 1
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(obs, "time", types.SimpleNamespace(time_ns=c.time_ns))
    return c


def _scene():
    """Nine cameras along a track looking at ten random 3D segments
    (rng seed 0)."""
    rng = np.random.default_rng(0)
    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(10, 3))
    d = rng.normal(size=(10, 3))
    Q = P + d / np.linalg.norm(d, axis=1, keepdims=True)
    views = []
    for i in range(9):
        R = lt.rotation_from_rpy(0, -0.04 * i + 0.15, 0)
        cam = lt.Camera(K, R, -R @ np.array([0.4 * i - 1.6, 0, 0]), 1920,
                        1080, median_depth=8.0)
        views.append((i, cam, np.hstack([cam.project(P), cam.project(Q)])))
    return views


def _drive(**cfg):
    pipe = lt.Line3D(lt.Config(**dict(CONFIG, **cfg)), device="cpu")
    for cam_id, cam, segs in _scene():
        pipe.add_view(cam_id, cam, segs)
    pipe.match_images()
    return [l.segments3d for l in pipe.reconstruct_3d_lines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene off, under ``obs.recording()`` and under the profiler,
    with each recorded run's record and the profiler's chrome trace."""
    torch.set_num_threads(2)
    obs.clear()
    off = _drive()
    with obs.recording():
        recorded = _drive()
    rec_on = obs.records()[-1]
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = _drive()
    rec_prof = obs.records()[-1]
    path = tmp_path_factory.mktemp("obs") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    return dict(off=off, recorded=recorded, profiled=profiled,
                rec_on=rec_on, rec_prof=rec_prof, trace=trace)


# --------------------------------------------------------------- off path
def test_off_a_span_is_the_shared_null_context(monkeypatch, clock):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = obs.span("add_view", Owner()), obs.span("recon.fit")
    assert a is b
    with a, b:
        pass
    assert obs.records() == [] and clock.reads == 0


def test_off_a_pipeline_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    pipe = lt.Line3D(lt.Config(), device="cpu")
    for cam_id, cam, segs in _scene()[:3]:
        pipe.add_view(cam_id, cam, segs)
    assert obs.records() == []


def test_off_a_launch_counts_in_launches_alone():
    before = dict(kernels.LAUNCHES)
    try:
        obs.launched("match_pairs")
        assert kernels.LAUNCHES["match_pairs"] == before["match_pairs"] + 1
        assert obs.records() == []
    finally:
        kernels.LAUNCHES.update(before)


# ------------------------------------------------------ synthetic spans
def test_nesting_parents_and_self_time(clock):
    owner = Owner()
    with obs.recording():
        with obs.span("reconstruct_3d_lines", owner):      # 0 .. 100
            clock.now = 10
            with obs.span("recon.edges"):                  # 10 .. 30
                clock.now = 30
            with obs.span("recon.bundle"):                 # 30 .. 90
                for k in range(3):                         # 40 .. 70
                    clock.now = 40 + 10 * k
                    with obs.span("recon.bundle.lm_iteration"):
                        clock.now += 10
                clock.now = 90
            clock.now = 100
        with obs.span("match_images", owner):              # 100 .. 150
            clock.now = 150
    recs = obs.records()
    assert len(recs) == 1
    spans = recs[0].spans
    assert [(s.name, s.parent, s.start, s.end) for s in spans] == [
        ("reconstruct_3d_lines", -1, 0, 100), ("recon.edges", 0, 10, 30),
        ("recon.bundle", 0, 30, 90),
        ("recon.bundle.lm_iteration", 2, 40, 50),
        ("recon.bundle.lm_iteration", 2, 50, 60),
        ("recon.bundle.lm_iteration", 2, 60, 70),
        ("match_images", -1, 100, 150)]
    got = obs.summary(recs[0])
    ms = 1e-6
    assert got["reconstruct_3d_lines"] == dict(
        count=1, total_ms=100 * ms, self_ms=20 * ms, launches=0)
    assert got["recon.bundle"]["self_ms"] == pytest.approx(30 * ms)
    assert got["recon.bundle.lm_iteration"]["count"] == 3
    assert got["recon.bundle.lm_iteration"]["total_ms"] == pytest.approx(
        30 * ms)
    assert got["match_images"]["self_ms"] == pytest.approx(50 * ms)


def test_each_pipeline_keeps_one_record(clock):
    first, second = Owner(), Owner()
    with obs.recording():
        for owner in (first, second, first):
            with obs.span("add_view", owner):
                with obs.span("recon.fit"):
                    pass
        # spans opened outside any pipeline share one record of their own
        for _ in range(2):
            with obs.span("recon.bundle.lm_iteration"):
                pass
    recs = obs.records()
    assert [len(r.spans) for r in recs] == [4, 2, 2]
    assert [r.owned for r in recs] == [True, True, False]
    assert len({r.id for r in recs}) == 3
    assert [s.parent for s in recs[0].spans] == [-1, 0, -1, 2]


def test_records_keep_the_newest(clock):
    with obs.recording():
        owners = [Owner() for _ in range(obs.KEEP + 5)]
        for owner in owners:
            with obs.span("match_images", owner):
                pass
    recs = obs.records()
    assert len(recs) == obs.KEEP
    assert [r.id for r in recs] == sorted(r.id for r in recs)


def test_a_launch_counts_in_launches_and_the_innermost_span(clock):
    before = dict(kernels.LAUNCHES)
    try:
        with obs.recording():
            with obs.span("match_images", Owner()):
                with obs.span("step.match"):
                    obs.launched("match_pairs")
                with obs.span("step.score"):
                    obs.launched("score_matches")
                    obs.launched("score_matches")
                obs.launched("gather_target_estimates")
        assert kernels.LAUNCHES["match_pairs"] == before["match_pairs"] + 1
        assert (kernels.LAUNCHES["score_matches"]
                == before["score_matches"] + 2)
        assert (kernels.LAUNCHES["gather_target_estimates"]
                == before["gather_target_estimates"] + 1)
        spans = obs.records()[0].spans
        assert [s.launches for s in spans] == [
            {"gather_target_estimates": 1}, {"match_pairs": 1},
            {"score_matches": 2}]
        got = obs.summary(obs.records()[0])
        assert got["step.score"]["launches"] == 2
        assert got["match_images"]["launches"] == 1
    finally:
        kernels.LAUNCHES.update(before)


def test_an_exception_closes_the_spans_it_leaves():
    with obs.recording():
        with pytest.raises(ValueError):
            with obs.span("reconstruct_3d_lines", Owner()):
                with obs.span("recon.fit"):
                    raise ValueError("stage failed")
        with obs.span("match_images", Owner()):
            pass
    first, second = obs.records()
    assert all(s.end is not None for s in first.spans)
    assert [s.parent for s in second.spans] == [-1]


# ------------------------------------------------------- a recorded scene
@pytest.mark.parametrize("which", ["rec_on", "rec_prof"])
def test_the_scene_records_every_span_of_its_path(runs, which):
    spans = runs[which].spans
    names = {s.name for s in spans}
    assert names == set(CACHED)
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        assert parent == CACHED[s.name], s
        assert s.start <= s.end
    got = obs.summary(runs[which])
    assert got["add_view"]["count"] == 9
    assert got["recon.bundle.lm_iteration"]["count"] == ITERATIONS
    assert all(got[n]["count"] == 1 for n in CACHED
               if n not in ("add_view", "recon.bundle.lm_iteration"))


def test_the_recon_stages_cover_the_reconstruction(runs):
    spans = runs["rec_on"].spans
    top = next(i for i, s in enumerate(spans)
               if s.name == "reconstruct_3d_lines")
    covered = sum(s.end - s.start for s in spans
                  if s.parent == top and s.name.startswith("recon."))
    assert covered >= 0.95 * (spans[top].end - spans[top].start)


def test_the_lines_are_bit_identical_with_recording_on_and_off(runs):
    off = runs["off"]
    assert len(off) >= 8
    for on in (runs["recorded"], runs["profiled"]):
        assert len(on) == len(off)
        for a, b in zip(off, on):
            np.testing.assert_array_equal(a, b)


def test_the_spans_are_the_traces_annotations_on_its_clock(runs):
    trace = runs["trace"]
    base = trace["baseTimeNanoseconds"]
    notes = {}
    for e in sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        notes.setdefault(e["name"], []).append(e)
    spans = runs["rec_prof"].spans
    assert len(spans) == sum(len(v) for v in notes.values())
    matched, diffs = [], []
    for s in spans:
        e = notes[s.name].pop(0)
        matched.append(e)
        diffs.append(abs((s.start - base) / 1000 - e["ts"]))
        if s.parent >= 0:
            p = matched[s.parent]
            assert p["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= (
                p["ts"] + p["dur"]), (s.name, p["name"])
    assert max(diffs) <= 2000.0
    assert statistics.median(diffs) <= 200.0


def test_the_blocked_path_records_a_span_per_block():
    with obs.recording():
        lines = _drive(view_block=4, optimize=False, collinearity_t=0.0,
                       perform_rdd=False)
    assert lines
    rec = obs.records()[-1]
    got = obs.summary(rec)
    assert got["step.block"]["count"] == 3                  # 9 views by 4
    assert got["step.match"]["count"] == 3
    assert got["step.affinity"]["count"] == 1
    block = {i for i, s in enumerate(rec.spans) if s.name == "step.block"}
    assert all(s.parent in block for s in rec.spans
               if s.name in ("step.match", "step.score", "step.filter"))


def test_detection_records_its_rounds():
    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=384, height=288)[4]
    img = synthetic.render(cam, quads, seed=104, ss=1)
    pipe = lt.Line3D(lt.Config(min_image_width=0), device="cpu")
    with obs.recording():
        pipe.add_images([(0, cam, img)])
    spans = obs.records()[-1].spans
    parent = {s.name: spans[s.parent].name if s.parent >= 0 else None
              for s in spans}
    assert parent == {
        "add_images": None, "lsd.detect": "add_images",
        "lsd.image": "lsd.detect", "lsd.round": "lsd.image",
        "lsd.components": "lsd.round", "lsd.fit": "lsd.round",
        "lsd.refine": "lsd.round", "lsd.nfa": "lsd.round",
        "lsd.consume": "lsd.round", "add_view": "add_images"}
    got = obs.summary(obs.records()[-1])
    assert got["lsd.round"]["count"] == 3
    assert got["lsd.consume"]["count"] == 2
    assert len(pipe._views[0].segments) > 0
