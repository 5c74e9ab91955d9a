"""What decides ``correct``, at a CPU test's size: the program against
the reference comes out correct; the control (the reference in TF32)
comes out not correct; and a run whose timed path is broken underneath
comes out not correct, once for each fault the cell can have: a stage
that returns its input unchanged, half of the views left out, and an
answer altered where it is produced.  (No cell spans chips, so none has
an exchange between chips to leave out.)  The sample reaches the end of
the window."""

import numpy as np
import pytest

from l3dbench import compare, drive, program, reference_run, registry, run
from l3dbench.tests.conftest import tiny_cell

from line3dpp_tpu_torch.models.pipeline import Line3D
from line3dpp_tpu_torch.ops import bundling, rdd

CELLS = [w["name"] for w in registry.benchmark()["workloads"]
         if registry.cell(w["name"])["spec"]["entry"] == "cached"]
SEED = 2**31 + 11


def run_tiny(name, classes=None, seconds=10.0, **size):
    return run.run_cell(tiny_cell(name, **size), SEED, seconds, False, "cpu",
                        classes=classes)


@pytest.mark.parametrize("name", CELLS)
def test_program_against_the_reference_is_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(
        registry.cell(name)["spec"]["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    source = registry.generator(cell["config"]["generator"]).Source(
        cell["config"], cell["spec"], SEED)
    inputs = source.scene(0)
    options = cell["spec"]["options"]
    pipe, _ = drive.scene(program.CLASSES, options, inputs, "cpu")
    state = drive.outputs(pipe)["state"]
    ref_step, _ = reference_run.step(options, inputs, "cpu")
    ref_lines = reference_run.recon(options, inputs, state, "cpu")
    ctl = dict(step=reference_run.step(options, inputs, "cpu", "tf32")[0],
               lines=reference_run.recon(options, inputs, state, "cpu",
                                         "tf32"))
    ok, checks = compare.judge([compare.numbers(ctl, ref_step, ref_lines)],
                               cell["spec"]["limits"])
    assert not ok, checks


def test_the_sample_reaches_the_end_of_the_window():
    res = run_tiny("testdata26.unbundled", seconds=30.0)
    info = res["_info"]
    assert info["scenes_in_window"] >= 3
    assert info["scenes_in_window"] - 1 in info["sample"]
    assert len(info["sample"]) == 2


class HalfTheViews(Line3D):
    def add_view(self, cam_id, camera, segments, worldpoints=None):
        if cam_id % 2 == 0:
            super().add_view(cam_id, camera, segments, worldpoints)


def move(lines, every):
    """Every ``every``-th line's first endpoint moved by 5% of the scene's
    scale."""
    scale = compare.scene_scale(np.concatenate(
        [l.segments3d for l in lines]))
    for line in lines[len(lines) // 2::every] if every else [
            lines[len(lines) // 2]]:
        line.segments3d[0, :3] += 0.05 * scale
    return lines


class OneLineMoved(Line3D):
    def reconstruct_3d_lines(self):
        return move(super().reconstruct_3d_lines(), 0)


class LinesMoved(Line3D):
    def reconstruct_3d_lines(self):
        return move(super().reconstruct_3d_lines(), 20)


def classes(line3d):
    return (line3d, *program.CLASSES[1:])


# the answer altered where it is produced: one line where the comparison
# holds every line (lines_gap), one in twenty where it holds the 99th
# percentile (a scene's one or two float32 flips set the largest gap)
ALTERED = {"testdata26.unbundled": OneLineMoved,
           "testdata26.bundled": LinesMoved,
           "testdata26.collinear_rdd": LinesMoved}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_the_views", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    line3d = HalfTheViews if fault == "half_the_views" else ALTERED[name]
    res = run_tiny(name, classes(line3d))
    assert not res["correct"], res["checks"]


def test_bundling_that_returns_its_lines_unchanged_is_not_correct(
        monkeypatch):
    def unchanged(lineP1, lineP2, *args, **kw):
        d = lineP2 - lineP1
        return lineP1, lineP2, d / np.linalg.norm(d, axis=-1, keepdims=True)

    monkeypatch.setattr(bundling, "optimize_cluster_lines", unchanged)
    res = run_tiny("testdata26.bundled")
    assert not res["correct"], res["checks"]


def test_rdd_that_returns_its_weights_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(rdd, "rdd_edges", lambda li, lj, w, *a, **k: w)
    res = run_tiny("testdata26.collinear_rdd")
    assert not res["correct"], res["checks"]


def test_a_scene_gives_what_the_comparison_needs():
    cell = tiny_cell("testdata26.unbundled")
    source = registry.generator("testdata").Source(
        cell["config"], cell["spec"], SEED)
    pipe, phases = drive.scene(program.CLASSES, cell["spec"]["options"],
                               source.scene(0), "cpu", traced=True)
    out = drive.outputs(pipe)
    assert set(phases) == {"add_views", "match_images",
                           "reconstruct_3d_lines"}
    assert out["n_lines"] == len(pipe.lines3d) > 0
    assert set(out["state"]) == set(drive.STATE_FIELDS) | {"neighbor_ids"}
    assert out["step"]["tgt"].shape == out["step"]["score"].shape


def test_scenes_of_one_seed_repeat_and_scenes_differ():
    cell = tiny_cell("testdata26.unbundled")
    gen = registry.generator("testdata")
    a = gen.Source(cell["config"], cell["spec"], SEED)
    b = gen.Source(cell["config"], cell["spec"], SEED)
    sa, sb = a.scene(3)["views"][0][6], b.scene(3)["views"][0][6]
    assert np.array_equal(sa, sb)
    assert not np.array_equal(sa, a.scene(4)["views"][0][6])
    base = a.views[0][6]
    assert np.abs(sa - base).max() <= cell["config"]["assumed"]["jitter_px"]
