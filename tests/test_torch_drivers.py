"""The port's drivers (``line3dpp_tpu_torch.bench`` and
``line3dpp_tpu_torch/tools/``) against the repository's JAX drivers, on
the CPU.

* ``bench.make_workload`` and ``tools.bench_scale.build_scene`` equal the
  JAX drivers' arrays bit for bit from the same seed (the JAX tool sets
  ``jax.config`` at import, so it runs in a subprocess).
* ``device_step_bench`` prints ``bench.py``'s last line (its four keys,
  the metric ``device_step_images_per_sec``), at a small size.
* ``drive_synthetic`` gives 12 lines at recall and precision 1.0.
* The eight configurations of the two facade sweeps, from JAX's facade
  detections (``tests/data/torch_scene2_3072_jax_reference.npz``), against
  JAX's lines under the same configurations
  (``tests/data/torch_scene2_sweep_jax_reference.npz``, from
  ``tests/make_torch_scene2_sweep_reference.py``), with ``chip_smoke.py``'s
  bounds: the count within 1% (at least one line) and count_f1 >= 0.99,
  0.97 with line bundling.  The port runs here with ``seg_pad=SEG_PAD``
  (the views hold at most 242 segments), where the drivers pad to the
  default 3000: padding changes nothing (``measure_torch_sweep_padding.py``
  finds the port's lines at 256 and 3000 bit-equal on the CPU for
  ``split_0.0_ordered``, ``split_1.1_full`` and the bundled ``anchor_0.0``
  and ``anchor_2.0``), and at 3000 one configuration takes minutes on the
  CPU.
* The sweeps through the drivers' own entry points on small renders: one
  detection shared through the geometry-keyed cache.
* Every driver raises without a card unless asked for the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch import bench
from line3dpp_tpu_torch.tools import (bench_scale, drive_synthetic,
                                      validate_scene2, validate_scene2_anchor)
from line3dpp_tpu_torch.utils import golden, synthetic

from make_torch_scene2_sweep_reference import (DEFAULT_OUT, detections,
                                               sweep_options)
from test_torch_lsd_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_PAD = 256
# chip_smoke.py's bounds for lines from the same segments
SAME_COUNT_REL = 0.01
SAME_F1 = 0.99
BUNDLED_SAME_F1 = 0.97


@pytest.mark.parametrize("sizes", [(26, 3000, 10), (3, 800, 2)],
                         ids=["bench_size", "small"])
def test_make_workload_equals_jax(sizes):
    got = bench.make_workload(*sizes)
    want = jax_bench.make_workload(*sizes)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))


def test_bench_scale_build_scene_equals_jax(tmp_path):
    path = tmp_path / "jax_scene.npz"
    code = (
        "import sys; import numpy as np\n"
        "sys.argv = ['bench_scale', '--cpu']\n"
        "sys.path.insert(0, 'tools')\n"
        "import bench_scale\n"
        "v = bench_scale.build_scene(104)\n"
        f"np.savez({str(path)!r}, segs=np.stack([s for _, s in v]),\n"
        "         K=np.stack([c.K for c, _ in v]),\n"
        "         R=np.stack([c.R for c, _ in v]),\n"
        "         t=np.stack([c.t for c, _ in v]),\n"
        "         wh=np.array([(c.width, c.height) for c, _ in v]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    views = bench_scale.build_scene(104)
    with np.load(path) as want:
        assert len(views) == len(want["segs"]) == 104
        for (cam, segs), ws, K, R, t, wh in zip(
                views, want["segs"], want["K"], want["R"], want["t"],
                want["wh"]):
            assert segs.shape == (3000, 4)
            for a, b in ((segs, ws), (cam.K, K), (cam.R, R), (cam.t, t)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            assert (cam.width, cam.height) == tuple(wh)


def test_device_step_bench_prints_bench_keys_on_cpu(capsys):
    info = bench.device_step_bench(V=2, S=800, N=1, device="cpu")
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "device_step_images_per_sec"
    assert line == info["result"]
    assert line["value"] > 0 and "CPU" in line["unit"]
    assert line["vs_baseline"] is None       # no card number from a CPU run
    assert len(info["runs_s"]) == 3 and info["same_outputs"]
    # the plain versions run on the CPU: no kernel launches
    assert all(not any(r.values()) for r in info["launches_per_run"])


def test_drive_synthetic_on_cpu(tmp_path):
    lines, m = drive_synthetic.run("cpu", str(tmp_path))
    assert len(lines) == 12
    assert m["recall"] == 1.0 and m["precision"] == 1.0
    rows = (tmp_path / "out.txt").read_text().strip().splitlines()
    assert len(rows) == 12
    n_segs = sum(len(l.segments3d) for l in lines)
    facets = (tmp_path / "out.stl").read_text().count(" endfacet")
    assert facets == n_segs
    assert (tmp_path / "out.obj").stat().st_size > 0


@pytest.fixture(scope="module")
def sweep_reference():
    with np.load(DEFAULT_OUT) as data:
        ref = {k: data[k] for k in data.files}
    segs, W, H, digest = detections()
    assert str(ref["detections"]) == digest, "made from other detections"
    return ref, segs, synthetic.make_cameras(len(segs), width=W, height=H)


@pytest.mark.parametrize("name", list(sweep_options()))
def test_sweep_from_jax_detections_matches_jax(sweep_reference, name):
    ref, segs, cams = sweep_reference
    opts = sweep_options()[name]
    assert json.loads(str(ref[f"{name}_config"])) == opts
    pipe = lt.Line3D(lt.Config(seg_pad=SEG_PAD, **opts), device="cpu")
    for i, (c, s) in enumerate(zip(cams, segs)):
        pipe.add_view(i, c, s)
    pipe.match_images()
    pred = [l.segments3d for l in pipe.reconstruct_3d_lines()]
    want = np.split(ref[f"{name}_lines"],
                    np.cumsum(ref[f"{name}_line_counts"])[:-1])
    assert len(want) > 50
    assert abs(len(pred) - len(want)) <= max(1, SAME_COUNT_REL * len(want))
    tol = 0.01 * golden.scene_scale(np.concatenate(want))
    f1 = golden.line_match_metrics(pred, want, tol)["count_f1"]
    assert f1 >= (BUNDLED_SAME_F1 if opts.get("optimize", True) else SAME_F1)
    assert all(np.isfinite(p).all() for p in pred)


def test_sweeps_share_one_detection_through_the_cache(tmp_path, monkeypatch):
    """Both sweeps through their entry points on 4 views rendered at 800 x
    300 (``seg_pad=128`` added to each configuration's options): the first
    configuration detects and stores in the geometry-keyed cache, and no
    later one (the anchor sweep's too) detects again; each sweep's first
    row holds the lines of a ``Line3D`` fed the cached segments."""
    from line3dpp_tpu_torch.models import pipeline

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    for tool in (validate_scene2, validate_scene2_anchor):
        monkeypatch.setattr(tool, "options", lambda *a, _f=tool.options:
                            dict(_f(*a), seg_pad=128))
    detected = []
    detect = pipeline.lsd_ops.detect_batch
    monkeypatch.setattr(pipeline.lsd_ops, "detect_batch", lambda imgs, *a,
                        **k: detected.append(len(imgs)) or detect(imgs, *a,
                                                                  **k))
    quads, gt = synthetic.build_scene()
    cams = synthetic.make_cameras(4, width=800, height=300)
    images = [synthetic.render(c, quads, seed=100 + i, ss=1)
              for i, c in enumerate(cams)]
    cache = validate_scene2.cache_dir(cams)
    assert os.path.dirname(cache) == str(tmp_path)
    assert cache != validate_scene2.cache_dir(synthetic.make_cameras(4))
    rows = validate_scene2.sweep(images, cams, gt, "cpu")
    assert len(os.listdir(cache)) == 4
    rows += validate_scene2_anchor.sweep(images, cams, gt, "cpu")
    assert detected == [4] and len(rows) == 8
    opts = list(sweep_options().values())           # patched too
    pipe = lt.Line3D(lt.Config(**opts[0]), device="cpu")
    pipe.add_images([(i, c, im) for i, (c, im) in enumerate(zip(cams,
                                                                images))],
                    cache_dir=cache)
    assert detected == [4]
    segs = [pipe._views[i].segments for i in range(4)]
    for r, kw in ((rows[0], opts[0]), (rows[4], opts[4])):
        pipe = lt.Line3D(lt.Config(**kw), device="cpu")
        for i, (c, s) in enumerate(zip(cams, segs)):
            pipe.add_view(i, c, s)
        pipe.match_images()
        want = pipe.reconstruct_3d_lines()
        assert r["lines"] == len(r["lines3d"]) == len(want) > 0
        for x, y in zip(r["lines3d"], want):
            assert np.array_equal(x.segments3d, y.segments3d)
    for r in rows:
        assert r["lines"] > 0 and 0 < r["recall"] <= 1
        assert set(r) >= {"precision", "count_f1", "seconds"}


def _images():
    cams = synthetic.make_cameras(2, width=64, height=48)
    return [(i, c, np.zeros((48, 64), np.uint8)) for i, c in enumerate(cams)]


@pytest.mark.parametrize("driver", [
    lambda: bench.main([]),
    lambda: bench.device_step_bench(V=2, S=800, N=1),
    lambda: bench.images_e2e(_images()),
    lambda: bench_scale.main(["4"]),
    lambda: drive_synthetic.main([]),
    lambda: validate_scene2.main(["--quick"]),
    lambda: validate_scene2.run_config(None, None, 0.0, "ordered"),
    lambda: validate_scene2_anchor.main(["--quick"]),
], ids=["bench", "device_step_bench", "images_e2e", "bench_scale",
        "drive_synthetic", "validate_scene2", "run_config",
        "validate_scene2_anchor"])
def test_drivers_raise_without_a_card(monkeypatch, driver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu|device='cpu'"):
        driver()
