"""The port's host formats and helpers against the JAX package's, on the
CPU: the reference's boost ``.bin`` archives (``utils/ref_bin``), the npz
variant and ``load_bin`` (``utils/writers``), ``Line3D.save_bin``, the
reference segment-cache import (``utils/segments_cache.load``),
``undistort_image`` (``ops/undistort``), ``utils/debug_draw`` and
``lsd.merge_collinear``.

Tolerances, with what was measured here:

* the ``.bin`` writers: byte-equal files; the readers: equal arrays.
* ``merge_collinear`` and the drawings: equal arrays (the same host numpy
  and PIL operations).
* ``undistort_image`` in float32: the Brown model and the bilinear sample
  are the same float32 operations in another order of evaluation (XLA on
  the CPU against torch); on 0-255 images they differ by at most 0.0085
  (atol 0.02, about 1e-4 of the range), and a uint8 image by at most 1
  level in at most 0.1% of its pixels (the float32 difference crossing an
  integer before the truncating cast; measured 22 of 76,800).
"""

import os

import numpy as np
import pytest
import torch

import line3dpp_tpu as jlt
import line3dpp_tpu_torch as lt
from line3dpp_tpu.ops import lsd as jlsd
from line3dpp_tpu.ops import undistort as jundistort
from line3dpp_tpu.utils import debug_draw as jdraw
from line3dpp_tpu.utils import ref_bin as jref
from line3dpp_tpu.utils import segments_cache as jcache
from line3dpp_tpu.utils import writers as jwriters
from line3dpp_tpu_torch.ops import lsd, undistort
from line3dpp_tpu_torch.utils import debug_draw, golden, ref_bin, \
    segments_cache, writers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(
    REPO, "testdata", "out",
    "Line3D-TPU__W_FULL__N_10__sigmaP_2.5__sigmaA_10__epiOverlap_0.25"
    "__kNN_10__vis_3.txt")


def _golden_lines():
    """The 2276 lines of the committed reconstruction as FinalLine3D."""
    return [writers.FinalLine3D(g.segments3d, g.residuals)
            for g in golden.parse_lines3d_txt(GOLDEN)]


def _seeded_lines(k, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(k):
        ns, nr = int(rng.integers(1, 5)), int(rng.integers(0, 6))
        res = np.zeros((nr, 6))
        res[:, 0] = rng.integers(0, 26, nr)
        res[:, 1] = rng.integers(0, 3000, nr)
        res[:, 2:] = rng.uniform(0, 3000, (nr, 4))
        lines.append(writers.FinalLine3D(rng.normal(size=(ns, 6)) * 10, res))
    return lines


MODELS = {"golden": _golden_lines, "none": lambda: _seeded_lines(0),
          "one": lambda: _seeded_lines(1), "seven": lambda: _seeded_lines(7)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_lines(a, b, residual_cols=6):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.segments3d, y.segments3d)
        np.testing.assert_array_equal(x.residuals[:, :residual_cols],
                                      y.residuals[:, :residual_cols])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_boost_bin_is_byte_equal_to_jax(tmp_path, model):
    """``save_bin_boost`` of both packages on the same lines: the same
    bytes; each package's ``load_bin`` reads either file to the same
    segments and (camID, segID) rows (the boost format keeps no 2D
    endpoints)."""
    lines = MODELS[model]()
    if model == "golden":
        assert len(lines) == 2276
    port, jax = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    ref_bin.save_bin_boost(port, lines)
    jref.save_bin_boost(jax, lines)
    assert _read(port) == _read(jax)
    for path in (port, jax):
        got, want = writers.load_bin(path), jwriters.load_bin(path)
        _same_lines(got, want)
        _same_lines(got, lines, residual_cols=2)
        assert all(not r.residuals[:, 2:].any() for r in got)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_npz_bin_reads_across_packages(tmp_path, model):
    """The npz variant: each package's ``load_bin`` reads the other's file
    to the lines written, residual endpoints included."""
    lines = MODELS[model]()
    port, jax = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    writers.save_bin(port, lines)
    jwriters.save_bin(jax, lines)
    assert os.path.exists(port) and not os.path.exists(port + ".npz")
    for path in (port, jax):
        _same_lines(writers.load_bin(path), jwriters.load_bin(path))
        _same_lines(writers.load_bin(path), lines)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 3000])
def test_segments_bin_is_byte_equal_to_jax(tmp_path, n):
    """The reference's per-image segment cache (``DataArray<float4>``,
    padded to an even count): both writers give the same bytes and both
    readers the float32 rows written."""
    segs = np.random.default_rng(7 + n).uniform(0, 3072, (n, 4))
    port, jax = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    ref_bin.save_reference_segments_bin(port, segs)
    jref.save_reference_segments_bin(jax, segs)
    assert _read(port) == _read(jax)
    for read in (ref_bin.load_reference_segments_bin,
                 jref.load_reference_segments_bin):
        got = read(port)
        assert got.shape == (n, 4) and got.dtype == np.float64
        np.testing.assert_array_equal(got, segs.astype(np.float32))


def test_readers_refuse_what_is_not_an_archive(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"\x05\x00\x00\x00\x00\x00\x00\x00hello" + bytes(40))
    for read in (ref_bin.load_reference_bin,
                 ref_bin.load_reference_segments_bin):
        with pytest.raises(ValueError, match="not a boost"):
            read(str(path))
    # a valid archive with a byte too many
    good = tmp_path / "good.bin"
    ref_bin.save_reference_segments_bin(str(good), np.ones((3, 4)))
    path.write_bytes(good.read_bytes() + b"\x00")
    with pytest.raises(ValueError, match="trailing bytes"):
        ref_bin.load_reference_segments_bin(str(path))


@pytest.mark.parametrize("fmt", ["boost", "npz"])
def test_line3d_save_bin(tmp_path, fmt):
    """``Line3D.save_bin`` writes JAX's ``Line3D.save_bin`` bytes (boost)
    or a file either package reads back (npz); another format raises."""
    lines = _seeded_lines(7, seed=3)
    pipe = lt.Line3D(lt.Config(optimize=False), device="cpu")
    pipe.lines3d = lines
    jpipe = jlt.Line3D(jlt.Config(optimize=False))
    jpipe.lines3d = lines
    port, jax = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    pipe.save_bin(port, fmt)
    jpipe.save_bin(jax, fmt)
    if fmt == "boost":
        assert _read(port) == _read(jax)
    for path in (port, jax):
        _same_lines(lt.load_bin(path), jlt.load_bin(path))
    with pytest.raises(ValueError, match="unknown bin format"):
        pipe.save_bin(port, "txt")


def test_segments_cache_imports_reference_workspace(tmp_path, capsys):
    """The workspace of ``tests/test_ref_bin.py``: both packages' ``load``
    import a full-resolution reference cache and a downscaled one (the
    max-dimension rule, line3D.cc:271-293), print the same line, and give
    None for another size and an absent view."""
    rng = np.random.default_rng(3)
    segs = rng.uniform(0, 3072, (40, 4))
    ref_bin.save_reference_segments_bin(
        str(tmp_path / "segments_L3D++_7_3072x2304_3000.bin"), segs)
    ref_bin.save_reference_segments_bin(
        str(tmp_path / "segments_L3D++_8_1000x750_3000.bin"), segs[:10])
    cases = [(7, -1, 40), (8, 1000, 10), (8, 500, None), (9, -1, None)]
    for cam, max_width, count in cases:
        args = (str(tmp_path), cam, (2304, 3072), 3000, max_width)
        got, want = segments_cache.load(*args), jcache.load(*args)
        out = capsys.readouterr().out.splitlines()
        if count is None:
            assert got is None and want is None and out == []
            continue
        assert got.shape == (count, 4)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, segs[:count].astype(np.float32))
        assert len(out) == 2 and out[0] == out[1] and "imported" in out[0]


def _garble(kind, path, monkeypatch):
    """Make the reference cache at ``path`` unreadable in the way
    ``kind`` names."""
    good = _read(path)
    if kind == "directory":
        os.remove(path)
        os.mkdir(path)
    elif kind == "raises":
        # a reader fault of a kind other than a bad file
        def boom(p):
            raise IndexError(f"{p}: count past the end")
        monkeypatch.setattr(ref_bin, "load_reference_segments_bin", boom)
        monkeypatch.setattr(jref, "load_reference_segments_bin", boom)
    else:
        data = {"truncated": good[:len(good) // 2],
                "trailing": good + b"\0" * 8,
                "random": np.random.default_rng(5).bytes(len(good))}[kind]
        with open(path, "wb") as f:
            f.write(data)


@pytest.mark.parametrize("kind", ["truncated", "trailing", "random",
                                  "directory", "raises"])
def test_segments_cache_unreadable_reference(tmp_path, capsys, monkeypatch,
                                             kind):
    """An unreadable reference cache, whatever the reader raises: both
    packages' ``load`` give None and print the same warning (the view is
    then detected again)."""
    path = tmp_path / "segments_L3D++_7_3072x2304_3000.bin"
    ref_bin.save_reference_segments_bin(
        str(path), np.random.default_rng(4).uniform(0, 3072, (40, 4)))
    _garble(kind, str(path), monkeypatch)
    args = (str(tmp_path), 7, (2304, 3072), 3000, -1)
    got, want = segments_cache.load(*args), jcache.load(*args)
    out = capsys.readouterr().out.splitlines()
    assert got is None and want is None
    assert len(out) == 2 and out[0] == out[1]
    assert "warning: unreadable reference segment cache" in out[0]


def test_undistort_matches_jax():
    """A seeded 240 x 320 image with nonzero k1, k2 and p1 (and all five
    coefficients): float32 within atol 0.02 of JAX's, uint8 within one
    level in at most 0.1% of the pixels."""
    rng = np.random.default_rng(0)
    K = np.array([[300.0, 0.0, 161.3], [0.0, 305.0, 118.7], [0.0, 0.0, 1.0]])
    for dist in ([0.12, -0.05, 0.0, 0.003, 0.0],
                 [-0.3, 0.1, 0.02, 0.001, -0.002], [0.08, 0.01]):
        img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
        got = undistort.undistort_image(img, K, np.array(dist), device="cpu")
        want = jundistort.undistort_image(img, K, np.array(dist))
        assert got.dtype == np.float32 and got.shape == img.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
        assert (got == 0).sum() == (want == 0).sum()     # outside: 0
        img8 = img.astype(np.uint8)
        got8 = undistort.undistort_image(img8, K, np.array(dist),
                                         device="cpu")
        want8 = jundistort.undistort_image(img8, K, np.array(dist))
        assert got8.dtype == np.uint8
        d = np.abs(got8.astype(int) - want8.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_undistort_without_distortion_returns_the_input():
    img = np.random.default_rng(1).uniform(0, 255, (24, 32)).astype(
        np.float32)
    K = np.eye(3)
    for dist in (np.zeros(5), np.full(5, 1e-13), np.zeros(0)):
        assert undistort.undistort_image(img, K, dist) is img
        assert jundistort.undistort_image(img, K, dist) is img
    if not torch.cuda.is_available():
        # the card by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            undistort.undistort_image(img, K, np.array([0.1]))


def _merge_inputs():
    """The segments of ``tests/test_lsd_merge.py`` and a seeded set of
    fragments along a few lines."""
    rng = np.random.default_rng(4)
    frags = []
    for _ in range(12):
        p, d = rng.uniform(0, 900, 2), rng.normal(size=2)
        d /= np.linalg.norm(d)
        t = np.sort(rng.uniform(0, 400, 6))
        for a, b in zip(t[:-1:2], t[1::2]):
            off = rng.normal(0, 0.3, 2)
            frags.append(np.r_[p + a * d + off, p + b * d + off])
    frags += [rng.uniform(0, 900, 4) for _ in range(30)]
    return {
        "fragments": np.array([[10.0, 50.0, 100.0, 50.0],
                               [104.0, 50.2, 200.0, 50.4],
                               [203.0, 50.5, 400.0, 51.0]]),
        "distinct": np.array([[10.0, 50.0, 100.0, 50.0],
                              [10.0, 80.0, 100.0, 80.0],
                              [10.0, 50.0, 15.0, 150.0],
                              [300.0, 50.0, 400.0, 50.0]]),
        "empty": np.zeros((0, 4)),
        "single": np.array([[0.0, 0.0, 10.0, 0.0]]),
        "seeded": np.array(frags),
    }


@pytest.mark.parametrize("name", sorted(_merge_inputs()))
def test_merge_collinear_matches_jax(name):
    segs = _merge_inputs()[name]
    got = lsd.merge_collinear(segs)
    np.testing.assert_array_equal(got, jlsd.merge_collinear(segs))
    if name == "seeded":
        assert 0 < len(got) < len(segs)


def test_debug_draw_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (60, 80)).astype(np.uint8)
    segs = rng.uniform(0, 80, (5, 4))
    for fn, args in (("draw_segments", (segs,)),
                     ("draw_single_segment", (segs[0],)),
                     ("draw_epipolar_line", (np.array([0.3, -1.0, 20.0]),))):
        got = getattr(debug_draw, fn)(img, *args)
        assert got.shape == (60, 80, 3)
        np.testing.assert_array_equal(got, getattr(jdraw, fn)(img, *args))
    P1, P2 = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    ok = np.array([1, 0, 1, 1, 0, 1], bool)
    debug_draw.save_temp_result_stl(str(tmp_path / "a.stl"), P1, P2, ok)
    jdraw.save_temp_result_stl(str(tmp_path / "b.stl"), P1, P2, ok)
    assert _read(str(tmp_path / "a.stl")) == _read(str(tmp_path / "b.stl"))


def test_exports_the_new_names():
    assert {"load_bin", "load_reference_bin", "undistort_image"} <= set(
        lt.__all__)
    for name in lt.__all__:
        assert hasattr(lt, name), name
    assert lt.undistort_image is undistort.undistort_image
    assert lt.load_reference_bin is ref_bin.load_reference_bin
