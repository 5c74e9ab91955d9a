"""Kernel K10 (``band_counts``) and the LSD rescue cascade of the port
against the JAX package's, on the CPU (the other LSD options:
``tests/test_torch_lsd_knobs.py``).

The JAX side runs as it runs on a TPU (``use_pallas_cc=True``, the Pallas
kernels in interpret mode), which is the path the port follows.

* K10: the counts are integers, and the port's plain version equals the
  interpret-mode kernel exactly, for the default symmetric bands, the
  asymmetric bands of ``tests/test_lsd_fit.py`` and the rescue's 15 bands
  (one call here, two calls of 8 and 7 bands in JAX).
* The detector with the rescue: the same number of segments, each at
  rtol 1e-3 / atol 0.1 of JAX's (the tolerance of ``tests/test_torch_lsd.py``),
  and the same ``n_rescue``.  The port evaluates the
  NFA in float64 and JAX in float32, so among a failing rectangle's 16
  rescue variants a near-tie could pick another band.  The noise scene of
  ``tests/test_lsd.py`` rescues nothing on this path (its one rescue comes
  from the XLA path's 16-iteration components; checked here: 0 in both
  packages), so the rescue cases are facade views 1 and 4 at 512 x 384
  without supersampling (3 and 4 rescued rectangles, in rounds 1 and 2).
  On view 4 ``n_rescue`` is equal and every segment lies within the
  tolerance of JAX's: no rescued rectangle picked a variant with another
  centre line (0 of 4).  On view 1 the port rescues one rectangle more
  (3 against 2) through the retry at half the angle tolerance, whose band
  ``|w_proj - mid| <= width / 2`` has the rectangle's two extreme pixels
  exactly on its edges: the port's extents are exact and keep them (12
  aligned pixels, log NFA 1.68), the Pallas extents kernel is off by up to
  1e-2 (``tests/test_lsd_fit.py:87``), its band came out 0.003 px narrower
  on that side and drops one (11 pixels fail).  The test holds view 1 to:
  every JAX segment is among the port's, and the port has at most one more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from line3dpp_tpu.ops import lsd_fit as jfit
from line3dpp_tpu_torch.ops import lsd, lsd_fit
from line3dpp_tpu_torch.utils import synthetic

from test_torch_lsd import _jax_pallas_core
from test_torch_lsd_cases import draw_segment, one_torch_thread, \
    random_sorted_case  # noqa: F401


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _band_case(seed, near_axis=False):
    """The inputs of tests/test_lsd_fit.py::test_band_counts; with
    ``near_axis`` the pixels are moved to integer positions within 40 px
    along and 8 px across their component's axis, so that every band
    holds pixels."""
    rng = np.random.default_rng(seed)
    c = 256
    slot, xs, ys, _, pix = random_sorted_case(rng)
    theta = rng.uniform(-np.pi, np.pi, c).astype(np.float32)
    tables = np.zeros((c, 8), np.float32)
    tables[:, 0] = np.cos(theta)
    tables[:, 1] = np.sin(theta)
    tables[:, 2] = rng.uniform(0, 500, c)
    tables[:, 3] = rng.uniform(0, 300, c)
    tables[:, 4] = rng.uniform(-3, 3, c)           # mid
    tables[:, 5] = rng.uniform(0.5, 12.0, c)       # width
    if near_axis:
        row = tables[np.minimum(slot, c - 1)]
        along = rng.uniform(-40, 40, len(slot))
        across = rng.uniform(-8, 8, len(slot))
        xs = np.rint(row[:, 2] + along * row[:, 0] - across * row[:, 1]
                     ).astype(np.float32)
        ys = np.rint(row[:, 3] + along * row[:, 1] + across * row[:, 0]
                     ).astype(np.float32)
    return c, slot, xs, ys, pix, tables


def _jax_band_counts(c, slot, xs, ys, pix, tables, bands):
    jt = np.zeros((8, c + jfit.WIN), np.float32)
    jt[:, :c] = tables.T
    out = []
    for lo in range(0, len(bands), 8):          # the Pallas kernel takes 8
        part = tuple(bands[lo:lo + 8])
        got = jfit.band_counts(*map(jnp.asarray, (slot, xs, ys, pix, jt)), c,
                               bands=part, interpret=True)
        out.append(np.asarray(got)[:len(part)])
    return np.concatenate(out).T                # (C, B)


ASYM_BANDS = ((-1.0, 1.0, 1.0, 0.0), (-1.0, 0.0, 1.0, -2.0),
              (-1.0, 3.0, 1.0, -1.0))


@pytest.mark.parametrize("bands", [lsd_fit.SYM_BANDS, ASYM_BANDS,
                                   lsd.RESCUE_BANDS],
                         ids=["sym", "asym", "rescue15"])
@pytest.mark.parametrize("near_axis", [False, True],
                         ids=["scattered", "near_axis"])
def test_k10_band_counts_match_jax(bands, near_axis):
    c, slot, xs, ys, pix, tables = _band_case(0, near_axis)
    got = lsd_fit.band_counts(*_t(slot, xs, ys, pix, tables), c, bands)
    assert got.dtype == torch.float32 and got.shape == (c, len(bands))
    want = _jax_band_counts(c, slot, xs, ys, pix, tables, bands)
    assert want.sum() > (100 * len(bands) if near_axis else 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k10_rejects_bad_bands_and_takes_a_tensor():
    c, slot, xs, ys, pix, tables = _band_case(1)
    args = _t(slot, xs, ys, pix, tables)
    with pytest.raises(ValueError, match="bands"):
        lsd_fit.band_counts(*args, c, ((0.0, 1.0, 2.0),))
    with pytest.raises(ValueError, match="bands"):
        lsd_fit.band_counts(*args, c, lsd_fit.SYM_BANDS * 5)
    as_tensor = torch.tensor(ASYM_BANDS)
    np.testing.assert_array_equal(
        lsd_fit.band_counts(*args, c, as_tensor).numpy(),
        lsd_fit.band_counts(*args, c, ASYM_BANDS).numpy())
    # no component: an empty table
    none = torch.full_like(args[0], 0)
    assert lsd_fit.band_counts(none, *args[1:4], tables=torch.zeros((0, 8)),
                               C=0).shape == (0, 4)


def test_first_argmax_takes_the_lowest_index_on_ties():
    t = torch.tensor([[1.0, 3.0, 3.0, 2.0], [-1e9, -1e9, -1e9, -1e9],
                      [0.0, 0.0, 5.0, 5.0]], dtype=torch.float64)
    assert lsd._first_argmax(t).tolist() == [1, 0, 2]


# ---------------------------------------------------------------------------
# the detector with each option
# ---------------------------------------------------------------------------

def _noise_image(seed, shape, truth):
    img = np.random.default_rng(seed).uniform(0, 8, size=shape).astype(
        np.float32)
    for p, q in truth:
        draw_segment(img, p, q)
    return img


def _rescue_image():
    """tests/test_lsd.py::test_rescue_cascade_wiring."""
    return _noise_image(0, (240, 400), [((15.0, 20.0), (380.0, 28.0)),
                                        ((40.0, 200.0), (360.0, 60.0)),
                                        ((30.0, 120.0), (370.0, 124.0))])


def _pair_image():
    """tests/test_lsd.py::test_side_split_wiring: a parallel pair."""
    return _noise_image(7, (96, 200), [((15.0, 40.0), (180.0, 44.0)),
                                       ((15.0, 42.0), (180.0, 46.0))])


def _three_image():
    """tests/test_lsd_fit.py::test_core_seed_center_gate_wiring."""
    return _noise_image(0, (96, 200), [((15.0, 20.0), (180.0, 28.0)),
                                       ((40.0, 80.0), (160.0, 30.0)),
                                       ((30.0, 60.0), (170.0, 64.0))])


def _jax_core(img, **opts):
    """``(segments, counts)`` of JAX ``_lsd_core`` as on a TPU."""
    d = {}
    return _jax_pallas_core(img, diag=d, **opts), d


def _unmatched(got, want):
    """How many segments of ``got`` have no segment of ``want`` within
    rtol 1e-3 / atol 0.1 in every coordinate."""
    close = np.abs(got[:, None, :] - want[None, :, :]) <= (
        0.1 + 1e-3 * np.abs(want[None, :, :]))
    return int((~close.all(-1).any(1)).sum())


def _assert_same_segments(got, want):
    assert len(got) == len(want) >= 2
    assert _unmatched(got, want) == 0 and _unmatched(want, got) == 0


def _facade_view(v):
    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=512, height=384)[v]
    return synthetic.render(cam, quads, seed=100 + v, ss=1).astype(
        np.float32)


@pytest.mark.parametrize("view", [1, 4])
def test_rescue_cascade_matches_jax_and_only_adds(view):
    img = _facade_view(view)
    t = torch.from_numpy(img)
    segs0, ok0, st0 = lsd._lsd_core(t)
    segs1, ok1, st1 = lsd._lsd_core(t, rescue=True)
    assert st0["n_rescue"] == 0 and st1["n_rescue"] >= 3
    assert int(ok1.sum()) >= int(ok0.sum())
    # the round-1 acceptances without the rescue all survive with it
    c1 = st0["rounds"][0]["components"]
    assert st1["rounds"][0]["components"] == c1
    base = {tuple(np.round(r, 3)) for r in segs1[:c1][ok1[:c1]].numpy()}
    for r in segs0[:c1][ok0[:c1]].numpy():
        assert tuple(np.round(r, 3)) in base
    want, d = _jax_core(img, rescue=True)
    got = segs1[ok1].numpy()
    if view == 4:
        assert st1["n_rescue"] == d["n_rescue"]
        _assert_same_segments(got, want)
    else:
        assert 0 <= st1["n_rescue"] - d["n_rescue"] <= 1
        assert 0 <= len(got) - len(want) <= 1
        assert _unmatched(want, got) == 0 and _unmatched(got, want) <= 1


def test_noise_scene_rescues_nothing_on_this_path():
    """As JAX's TPU path (10 segments, ``n_rescue`` 0, measured once with
    ``_jax_core``; a run costs 35 s)."""
    _, ok, st = lsd._lsd_core(torch.from_numpy(_rescue_image()), rescue=True)
    assert st["n_rescue"] == 0 and int(ok.sum()) == 10
