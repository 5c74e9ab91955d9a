"""The port's segment cache (``line3dpp_tpu_torch/utils/segments_cache``)
against the JAX package's on the same directories: an unreadable ``.npz``
and a reference ``.bin`` of another size give None in both (the view is
detected again); a reference ``.bin`` that JAX imports the port imports
too, and an unreadable one gives None in both, with a warning; the port's
writer round-trips and leaves no temporary file.  (Readable reference
caches: ``tests/test_torch_formats.py``.)"""

import os

import numpy as np
import pytest

from line3dpp_tpu.utils import segments_cache as jax_cache
from line3dpp_tpu_torch.utils import segments_cache

SHAPE = (960, 1280)          # (H, W)
MAX_SEGMENTS = 3000


def _both(tmp_path, cam_id, shape=SHAPE, max_width=-1):
    args = (str(tmp_path), cam_id, shape, MAX_SEGMENTS, max_width)
    return segments_cache.load(*args), jax_cache.load(*args)


@pytest.mark.parametrize("keep", [0.0, 0.5, 0.9])
def test_truncated_npz_gives_none_in_both(tmp_path, keep):
    segs = np.random.default_rng(1).uniform(0, 900, (50, 4))
    segments_cache.store(str(tmp_path), 3, SHAPE, MAX_SEGMENTS, segs)
    path = segments_cache._path(str(tmp_path), 3, SHAPE, MAX_SEGMENTS)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:int(keep * len(data))])
    port, jax = _both(tmp_path, 3)
    assert port is None and jax is None


def _bin(tmp_path, cam_id, w, h):
    path = tmp_path / f"segments_L3D++_{cam_id}_{w}x{h}_{MAX_SEGMENTS}.bin"
    path.write_bytes(b"")
    return str(path)


@pytest.mark.parametrize("dw,dh,max_width", [
    (3, 0, -1), (0, -3, -1), (2, 1, -1), (-2, -2, -1), (40, 30, -1),
    (0, 0, 640)])
def test_reference_bin_of_another_size_gives_none_in_both(tmp_path, dw, dh,
                                                          max_width):
    """More than 2 px off the expected processed size (the full size, or
    the downscaled one under ``max_width``): neither package imports it."""
    _bin(tmp_path, 5, SHAPE[1] + dw, SHAPE[0] + dh)
    args = (str(tmp_path), 5, SHAPE, max_width)
    assert jax_cache._reference_path(*args) is None
    assert segments_cache._reference_path(*args) is None
    port, jax = _both(tmp_path, 5, max_width=max_width)
    assert port is None and jax is None


@pytest.mark.parametrize("w,h,max_width", [
    (1280, 960, -1), (1281, 960, -1), (1279, 959, -1), (1280, 958, -1),
    (640, 480, 640), (641, 481, 640), (1280, 960, 2000)])
def test_reference_bin_within_2px_raises_where_jax_imports(tmp_path, w, h,
                                                           max_width,
                                                           capsys):
    """Within 2 px of the expected processed size both packages import the
    file; this one is empty, so both warn and give None (the view is
    detected again).  The port no longer raises there: it imports as JAX
    does."""
    path = _bin(tmp_path, 6, w, h)
    _bin(tmp_path, 6, w + 50, h)                    # another size beside it
    _bin(tmp_path, 7, w, h)                         # another view
    args = (str(tmp_path), 6, SHAPE, max_width)
    assert jax_cache._reference_path(*args) == path
    assert segments_cache._reference_path(*args) == path
    port, jax = _both(tmp_path, 6, max_width=max_width)
    assert port is None and jax is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert "unreadable reference segment cache" in out[0] and path in out[0]


@pytest.mark.parametrize("max_width", [-1, 640])
def test_store_then_load_round_trips(tmp_path, max_width):
    segs = np.random.default_rng(2).uniform(0, 900, (37, 4)).astype(
        np.float32)
    cache = str(tmp_path / "cache")
    segments_cache.store(cache, 4, SHAPE, MAX_SEGMENTS, segs, max_width)
    assert os.listdir(cache) == [os.path.basename(segments_cache._path(
        cache, 4, SHAPE, MAX_SEGMENTS, max_width))]
    for got in (segments_cache.load(cache, 4, SHAPE, MAX_SEGMENTS, max_width),
                jax_cache.load(cache, 4, SHAPE, MAX_SEGMENTS, max_width)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, segs)
    # a second store replaces the file
    segments_cache.store(cache, 4, SHAPE, MAX_SEGMENTS, segs[:5], max_width)
    np.testing.assert_array_equal(
        segments_cache.load(cache, 4, SHAPE, MAX_SEGMENTS, max_width),
        segs[:5])
    assert len(os.listdir(cache)) == 1
