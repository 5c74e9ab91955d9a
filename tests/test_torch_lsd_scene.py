"""The synthetic facade: the port's renderer against the tool's, and images
to 3D lines through the port against the JAX package, on the CPU.

Images to lines: the first 4 views at 1024 x 768 (2x supersampled, as
``tools/validate_scene2.py`` renders them), ``Config(optimize=False,
num_neighbors=3)``.  The port detects and reconstructs live.  The JAX
package reconstructs live, from its own detections, which
``tests/make_torch_lsd_reference.py`` wrote to
``tests/data/torch_scene2_1024_jax_reference.npz`` with its TPU detection
path (Pallas kernels in interpret mode, about 20 s a view here, too slow to
rerun in every test run), and from the port's detections.  Measured:

* detections: the same segment count in every view; in each of views 0
  and 1 one short near-vertical segment (of 38 and 53) has an endpoint
  1.09 and 1.26 px away, because the two packages sum the fit moments in
  different orders (float64 against float32 one-hot products) and its
  axis is ill-conditioned.  Bounds: per view the count within 2% and
  mutual 1-px endpoint coverage >= 0.97 (one segment in 38 is 0.026);
  over all views >= 0.98.
* reconstruction from the same (the port's) detections: 20 lines from
  each package, count_f1 1.0.  Bounds as tests/test_torch_pipeline.py:
  line count within 2, count_f1 >= 0.99.
* end to end (each package from its own detections): 20 lines against
  17, count_f1 0.919.  With 4 views and 3 neighbours the two moved
  segments change which segments cluster.  Bounds: line count within 3,
  count_f1 >= 0.9, at the measured values: on the CPU both runs are
  deterministic, so these hold the port's summation order where it lands.

How far the order alone moves these (``tests/measure_torch_lsd_facade.py
--ref tests/data/torch_scene2_1024_jax_reference.npz``: the port with
float64 sums, float32 sums in list order and in 5 random orders): per-view
coverage against JAX 0.9474-1.0, the same segment counts, and 18-23 lines
at count_f1 0.79-0.94 against JAX's.  No bound holds every order and stays
tight, so the tight parity checks are the detections' and the
reconstruction from the same detections.
"""

import os
import sys

import jax
import numpy as np
import pytest

import line3dpp_tpu as l3d
import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch.utils import golden, synthetic

from test_torch_lsd_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_1024 = os.path.join(REPO, "tests", "data",
                        "torch_scene2_1024_jax_reference.npz")


@pytest.fixture(scope="module")
def tool():
    """``tools/validate_scene2.py`` imported with the JAX configuration it
    sets at import restored afterwards."""
    cache_dir = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import validate_scene2
    finally:
        sys.path.pop(0)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return validate_scene2


def test_scene_and_cameras_match_the_tool(tool):
    quads, gt = synthetic.build_scene()
    tquads, tgt = tool.build_scene()
    np.testing.assert_array_equal(gt, tgt)
    assert [k for k, _ in quads] == [k for k, _ in tquads]
    for (_, q), (_, tq) in zip(quads, tquads):
        np.testing.assert_array_equal(q, tq)
    for c, tc in zip(synthetic.make_cameras(10), tool.make_cameras(10)):
        for a, b in ((c.K, tc.K), (c.R, tc.R), (c.t, tc.t)):
            np.testing.assert_array_equal(a, b)
        assert (c.width, c.height) == (tc.width, tc.height)


@pytest.mark.parametrize("view", [0, 7])
def test_render_is_byte_equal_to_the_tool(tool, monkeypatch, view):
    """At a reduced 256 x 192 (the tool's W and H patched; its cameras keep
    their 900 px focal length, so the facade overfills the frame)."""
    monkeypatch.setattr(tool, "W", 256)
    monkeypatch.setattr(tool, "H", 192)
    quads, _ = tool.build_scene()
    tcam = tool.make_cameras(10)[view]
    cam = lt.Camera(tcam.K, tcam.R, tcam.t, tcam.width, tcam.height)
    want = tool.render(tcam, quads, seed=100 + view)
    got = synthetic.render(cam, synthetic.build_scene()[0], seed=100 + view,
                           ss=tool.SS)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == (192, 256)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def facade_runs():
    with np.load(REF_1024) as data:
        ref = {k: data[k] for k in data.files}
    W, H, V = int(ref["width"]), int(ref["height"]), len(ref["seg_counts"])
    quads, gt = synthetic.build_scene()
    cams = synthetic.make_cameras(10, width=W, height=H)[:V]
    images = [synthetic.render(c, quads, seed=100 + i, ss=int(ref["ss"]))
              for i, c in enumerate(cams)]
    assert [synthetic.image_digest(im) for im in images] == list(
        ref["digests"])
    ref_segs = np.split(ref["segments"], np.cumsum(ref["seg_counts"])[:-1])
    kw = dict(optimize=False, num_neighbors=int(ref["neighbors"]))

    port = lt.Line3D(lt.Config(**kw), device="cpu")
    port.add_images([(i, c, im) for i, (c, im) in enumerate(zip(cams,
                                                                images))])
    port.match_images()
    port_lines = port.reconstruct_3d_lines()

    def jax_lines(seg_lists):
        jpipe = l3d.Line3D(l3d.Config(**kw))
        for i, (c, s) in enumerate(zip(cams, seg_lists)):
            jpipe.add_view(i, l3d.Camera(c.K, c.R, c.t, c.width, c.height),
                           s)
        jpipe.match_images()
        return jpipe.reconstruct_3d_lines()

    port_segs = [port._views[i].segments for i in range(V)]
    return dict(port=port, port_lines=port_lines, ref_segs=ref_segs,
                jax_lines=jax_lines(ref_segs),
                jax_on_port=jax_lines(port_segs), gt=gt)


def _count_f1(a, b, gt):
    return golden.line_match_metrics(
        [l.segments3d for l in a], [l.segments3d for l in b],
        0.01 * golden.scene_scale(gt))["count_f1"]


def test_facade_detections_match_jax(facade_runs):
    port, ref_segs = facade_runs["port"], facade_runs["ref_segs"]
    covered = total = 0
    for i, want in enumerate(ref_segs):
        got = port._views[i].segments
        assert len(want) > 20
        assert abs(len(got) - len(want)) <= 0.02 * len(want), i
        cov, n_cov, n = golden.mutual_coverage(got, want)
        assert cov >= 0.97, (i, cov)
        covered += n_cov
        total += n
    assert covered / total >= 0.98


def test_facade_reconstruction_from_the_same_detections(facade_runs):
    port, jax_ = facade_runs["port_lines"], facade_runs["jax_on_port"]
    assert len(jax_) > 10
    assert abs(len(port) - len(jax_)) <= 2
    assert _count_f1(port, jax_, facade_runs["gt"]) >= 0.99


def test_facade_images_to_lines_match_jax(facade_runs):
    port, jax_ = facade_runs["port_lines"], facade_runs["jax_lines"]
    assert len(jax_) > 10
    assert abs(len(port) - len(jax_)) <= 3
    assert _count_f1(port, jax_, facade_runs["gt"]) >= 0.9
