"""The port's LSD detection against the JAX package's, on the CPU.

Inputs are made with numpy and go through both packages.  Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it.  Tolerances, with what was measured here:

* K4 (tile labels), the border merge, K5/K6 (the label gathers) and K9
  (gate): exact.
* K7/K8 sums: rtol 1e-5.  The port sums the float32 terms in float64, the
  interpret-mode kernel in float32 one-hot matrix products (measured
  largest relative difference ~1e-6).
* K11 extents: atol 1e-2, the rounding of the JAX kernel's head-scatter
  sentinel (``tests/test_lsd_fit.py:87``); the port's minima are exact.
* Blur, resize and the angle field: the same float32 operations, measured
  at most a few ulp apart (see each test); the used mask and its compaction
  order are equal.
* betainc: the port's float64 fraction against JAX's float32 one; their
  log10 differ by < 1e-4 over the (a, b) range detection produces.
* ``_lsd_core`` and ``detect`` on the images of ``tests/test_lsd.py`` and
  ``tests/test_lsd_fit.py``: the same segments at the tolerance the JAX
  package holds its own two paths to (rtol 1e-3, atol 0.1).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from line3dpp_tpu.ops import lsd as jlsd
from line3dpp_tpu.ops import lsd_cc as jcc
from line3dpp_tpu.ops import lsd_fit as jfit
from line3dpp_tpu.ops import lsd_gather as jgather
from line3dpp_tpu_torch.ops import lsd, lsd_cc, lsd_fit, lsd_gather
from line3dpp_tpu_torch.ops.special import betainc

from test_torch_lsd_cases import draw_segment, lines_image, \
    one_torch_thread, random_sorted_case, random_tables  # noqa: F401

TILE = (8, 128)
FIT_KERNELS = ("moments", "gate_moments", "gate_pixels", "extents")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_tables(tables):
    """(C, 8) port tables -> the JAX kernels' (8, C + WIN) layout."""
    c = tables.shape[0]
    out = np.zeros((8, c + jfit.WIN), np.float32)
    out[:, :c] = tables.T
    return jnp.asarray(out)


# ---------------------------------------------------------------------------
# K4 and the border merge
# ---------------------------------------------------------------------------

def _lines_grid():
    """Crossing lines over the 2 x 2 tiles of tests/test_lsd_cc.py."""
    angle = np.full((16, 256), 99.0, np.float32)
    active = np.zeros((16, 256), bool)
    for x0, y0, x1, y1, th in ((10, 3, 245, 3, 0.3), (60, 0, 75, 15, -0.8),
                               (200, 1, 200, 14, 1.4)):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        angle[ys, xs] = th
        active[ys, xs] = True
    angle[12, 30], active[12, 30] = 2.0, True
    return angle, active, math.radians(22.5)


def _random_grid(seed):
    rng = np.random.default_rng(seed)
    angle = rng.uniform(-math.pi, math.pi, (16, 256)).astype(np.float32)
    return angle, rng.uniform(size=(16, 256)) < 0.35, 0.3


def _blob_grid(seed):
    rng = np.random.default_rng(seed)
    angle = rng.uniform(0.5, 0.9, (16, 256)).astype(np.float32)
    return angle, rng.uniform(size=(16, 256)) < 0.7, 0.3


@pytest.mark.parametrize("grid", [_lines_grid, functools.partial(
    _random_grid, 0), functools.partial(_random_grid, 5), functools.partial(
    _blob_grid, 1)], ids=["lines", "random0", "random5", "blob"])
def test_k4_and_merge_match_jax(grid):
    """Tile labels equal the interpret-mode Pallas kernel's; merged labels
    equal the JAX merge's and the XLA whole-grid components."""
    angle, active, tol = grid()
    tol = np.float32(tol)
    lab, unconv = lsd_cc.cc_tiles(*_t(angle, active), float(tol), TILE)
    a, m = jnp.asarray(angle), jnp.asarray(active)
    jlab, jconv = jcc.cc_tiles(a, m, jnp.float32(tol), tile=TILE,
                               max_iters=512, interpret=True)
    assert int(jconv[0, 0]) == 0 and int(unconv.sum()) == 0
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))

    T, n_links = lsd_cc.merge_tile_labels(lab, *_t(angle, active),
                                          float(tol), TILE)
    jT, jn = jcc.merge_tile_labels(jlab, a, m, jnp.float32(tol), tile=TILE)
    assert n_links == int(jn)
    valid = lab != lsd_cc.INVALID
    merged = torch.where(valid, T[lab.clamp(max=T.numel() - 1).long()],
                         lsd_cc.INVALID).numpy()
    jmerged = np.where(np.asarray(valid), np.asarray(jT)[np.minimum(
        np.asarray(jlab), jT.shape[0] - 1)], lsd_cc.INVALID)
    np.testing.assert_array_equal(merged, jmerged)
    np.testing.assert_array_equal(merged, np.asarray(
        jlsd._connected_components(a, m, jnp.float32(tol), n_iters=64)))

    # K5 applies T to the grid, K6 gathers at the active pixels: both equal
    # the interpret-mode Pallas kernels
    dense = lsd_gather.apply_merge_dense(lab, T)
    jdense = jgather.apply_merge_dense(jlab, jT, TILE, lsd_cc.INVALID,
                                       interpret=True)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
    np.testing.assert_array_equal(dense.numpy(), merged)
    idx = torch.nonzero(torch.from_numpy(active).reshape(-1))[:, 0]
    got = lsd_gather.gather_labels(dense.reshape(-1), idx).numpy()
    n = idx.numel()
    padded = np.full(-(-n // jgather.CHUNK) * jgather.CHUNK, idx[-1].item(),
                     np.int32)
    padded[:n] = idx.numpy()
    want, ovf = jgather.gather_sorted(jdense.reshape(-1), jnp.asarray(padded),
                                      fill=-1, n_valid=n, interpret=True)
    assert int(ovf) == 0
    np.testing.assert_array_equal(got, np.asarray(want)[:n])


def _tile_rooted_labels(rng, th, tw, hp, wp):
    """In-tile flat-index labels, 30% INVALID (tests/test_lsd_gather.py)."""
    lab = np.empty((hp, wp), np.int32)
    for i in range(hp // th):
        for j in range(wp // tw):
            ys = rng.integers(i * th, (i + 1) * th, (th, tw))
            xs = rng.integers(j * tw, (j + 1) * tw, (th, tw))
            lab[i * th:(i + 1) * th, j * tw:(j + 1) * tw] = ys * wp + xs
    lab[rng.uniform(size=(hp, wp)) < 0.3] = lsd_cc.INVALID
    return lab


def test_k5_apply_merge_dense_matches_jax():
    """The random tile-rooted labels and map of tests/test_lsd_gather.py."""
    rng = np.random.default_rng(11)
    th, tw = 16, 256
    lab = _tile_rooted_labels(rng, th, tw, 2 * th, 2 * tw)
    T = rng.integers(0, 1 << 23, lab.size).astype(np.int32)
    got = lsd_gather.apply_merge_dense(*_t(lab, T)).numpy()
    want = np.asarray(jgather.apply_merge_dense(
        jnp.asarray(lab), jnp.asarray(T), (th, tw), lsd_cc.INVALID,
        interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("span", ["narrow", "wide"])
def test_k6_gather_labels_matches_jax(span):
    """Sorted indices with small and with wide per-tile spans (the inputs of
    tests/test_lsd_gather.py, where the Pallas kernel covers every entry);
    the port's gather takes the same indices in any order."""
    rng = np.random.default_rng(12)
    n_src, n = 128 * 8192, 8 * 1024
    src = rng.integers(0, 1 << 23, n_src).astype(np.int32)
    pool = n_src // 16 if span == "narrow" else n_src
    idx = np.sort(rng.choice(pool, n, replace=False))
    want, ovf = jgather.gather_sorted(jnp.asarray(src),
                                      jnp.asarray(idx.astype(np.int32)),
                                      win_rows=512, fill=-1, interpret=True)
    assert int(ovf) == 0
    src_t, idx_t = _t(src, idx.astype(np.int64))
    np.testing.assert_array_equal(
        lsd_gather.gather_labels(src_t, idx_t).numpy(), np.asarray(want))
    perm = torch.from_numpy(rng.permutation(n))
    np.testing.assert_array_equal(
        lsd_gather.gather_labels(src_t, idx_t[perm]).numpy(),
        np.asarray(want)[perm.numpy()])


# ---------------------------------------------------------------------------
# K7, K8, K9, K11
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fit_case():
    rng = np.random.default_rng(0)
    c = 256
    slot, xs, ys, mag, pix = random_sorted_case(rng)
    tables, ang = random_tables(rng, c, len(slot))
    return c, (slot, xs, ys, mag, pix, tables, ang)


def test_k7_moments_match_jax(fit_case):
    c, (slot, xs, ys, mag, pix, _, _) = fit_case
    got = lsd_fit.moments(*_t(slot, xs, ys, mag, pix), c).numpy()
    want = np.asarray(jfit.moments(*map(jnp.asarray, (slot, xs, ys, mag, pix)),
                                   c, interpret=True))
    np.testing.assert_allclose(got, want[:, :c].T, rtol=1e-5, atol=0)


def test_k11_extents_match_jax(fit_case):
    c, (slot, xs, ys, _, pix, tables, _) = fit_case
    tables = tables.copy()
    tables[:, 4] = lsd_fit.BIG
    got = lsd_fit.extents(*_t(slot, xs, ys, pix, tables), c).numpy()
    want = np.asarray(jfit.extents(*map(jnp.asarray, (slot, xs, ys, pix)),
                                   _jax_tables(tables), c, interpret=True))
    want = want[:4, :c].T
    np.testing.assert_array_equal(got == lsd_fit.BIG, want == lsd_fit.BIG)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("dump_keep", [True, False])
@pytest.mark.parametrize("cos_tol", [-2.0, 0.8, float(lsd.COS_GATE)])
def test_k9_gate_and_k8_match_jax(fit_case, dump_keep, cos_tol):
    """K9's newpix exactly; K8's newpix exactly and its sums at rtol 1e-5."""
    c, (slot, xs, ys, mag, pix, tables, ang) = fit_case
    jt = _jax_tables(tables)
    j = dict(slot=jnp.asarray(slot), xs=jnp.asarray(xs), ys=jnp.asarray(ys),
             ang=jnp.asarray(ang))
    got9 = lsd_fit.gate_pixels(*_t(slot, xs, ys, ang, pix, tables),
                               dump_keep, cos_tol, c).numpy()
    want9 = np.asarray(jfit.gate_pixels(
        j["slot"], j["xs"], j["ys"], j["ang"], jnp.asarray(pix), jt,
        jnp.bool_(dump_keep), jnp.float32(cos_tol), c, interpret=True))
    np.testing.assert_array_equal(got9, want9)

    newpix, mom = lsd_fit.gate_moments(
        *_t(slot, xs, ys, ang, mag, pix, tables), dump_keep, cos_tol, c)
    jpix, jmom = jfit.gate_moments(
        j["slot"], j["xs"], j["ys"], j["ang"], jnp.asarray(mag),
        jnp.asarray(pix), jt, jnp.bool_(dump_keep), jnp.float32(cos_tol), c,
        interpret=True)
    np.testing.assert_array_equal(newpix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(newpix.numpy(), got9)
    np.testing.assert_allclose(mom.numpy(), np.asarray(jmom)[:, :c].T,
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# stencils, compaction, betainc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,out", [((37, 53), (30, 42)),
                                       ((120, 160), (96, 128)),
                                       ((40, 30), (57, 61)),
                                       ((200, 300), (100, 150))])
def test_resize_matches_jax(shape, out):
    """Antialiased 0.8 shrinks, an enlargement and a 2x shrink."""
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    got = lsd._bilinear_resize(torch.from_numpy(img), *out).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), out, "bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_blur_matches_jax():
    img = np.random.default_rng(4).uniform(0, 255, (50, 70)).astype(
        np.float32)
    kern = jlsd._gaussian_kernel(lsd.SIGMA_SCALE / lsd.SCALE)
    np.testing.assert_array_equal(
        lsd._gaussian_kernel(lsd.SIGMA_SCALE / lsd.SCALE), kern)
    got = lsd._separable_blur(torch.from_numpy(img), kern).numpy()
    want = np.asarray(jlsd._separable_blur(jnp.asarray(img),
                                           jnp.asarray(kern)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(160, 200), (96, 200)])
def test_grad_compact_matches_jax(shape):
    img = lines_image(shape=shape)
    H, W = shape
    angle, used, idx, mag_c, ang_c = lsd._grad_compact(torch.from_numpy(img))
    (jangle, jused, jcount, jidx, jvalid, jmag,
     jang) = jlsd._grad_compact(jnp.asarray(img), H, W)
    n = int(jcount)
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx)[:n])
    np.testing.assert_allclose(angle.numpy(), np.asarray(jangle), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(mag_c.numpy(), np.asarray(jmag)[:n],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ang_c.numpy(), np.asarray(jang)[:n], rtol=0,
                               atol=1e-4)


def test_betainc_matches_jax():
    """I_p(k, n - k + 1) at p = 0.125 over the range the NFA test sees:
    5 <= k <= 4000 aligned pixels in rectangles of up to 20000 pixels.

    Against JAX's float64 betainc: relative 1e-9 (measured 6e-11).  The
    JAX package's detector evaluates it in float32, whose own error reaches
    0.0094 in log10 here (measured against its float64 result), so the two
    detectors' log NFA differ by up to 0.01."""
    rng = np.random.default_rng(5)
    n = rng.integers(5, 20000, 400)
    k = np.minimum(rng.integers(5, 4000, 400), n)
    a, b = k.astype(np.float64), (n - k + 1).astype(np.float64)
    got = betainc(*_t(a, b), lsd.P_NFA).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax.scipy.special.betainc(
            jnp.asarray(a), jnp.asarray(b), jnp.float64(lsd.P_NFA)))
    assert want.dtype == np.float64
    live = want > 1e-300
    assert live.sum() > 200
    np.testing.assert_allclose(got[live], want[live], rtol=1e-9, atol=0)

    want32 = np.asarray(jax.scipy.special.betainc(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.float32(lsd.P_NFA)))
    live = want32 > 1e-30          # float32 underflows below ~1e-38
    assert live.sum() > 100
    np.testing.assert_allclose(np.log10(got[live]), np.log10(want32[live]),
                               rtol=0, atol=0.01)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

def _fit_case_image():
    """The image of tests/test_lsd_fit.py::test_core_pallas_path_matches_xla
    (its ``rng`` fixture is default_rng(0))."""
    img = np.random.default_rng(0).uniform(0, 8, size=(96, 200)).astype(
        np.float32)
    for p, q in [((15.0, 20.0), (180.0, 28.0)),
                 ((40.0, 80.0), (160.0, 30.0))]:
        draw_segment(img, p, q)
    return img


IMAGES = {"test_lsd": lines_image, "test_lsd_fit": _fit_case_image}


def _jax_pallas_core(img):
    """JAX ``_lsd_core`` as it runs on a TPU (Pallas CC and fit kernels,
    here in interpret mode; the per-pixel label gather)."""
    saved = [(jcc, "cc_tiles")] + [(jfit, n) for n in FIT_KERNELS]
    orig = [getattr(m, n) for m, n in saved]
    for (m, n), fn in zip(saved, orig):
        setattr(m, n, functools.partial(fn, interpret=True))
    jlsd._lsd_round.clear_cache()
    try:
        segs, ok, _ = jlsd._lsd_core(jnp.asarray(img), *img.shape,
                                     use_pallas_cc=True,
                                     use_pallas_gather=False)
    finally:
        for (m, n), fn in zip(saved, orig):
            setattr(m, n, fn)
        jlsd._lsd_round.clear_cache()
    return np.asarray(segs)[np.asarray(ok)]


def _assert_same_segments(got, want):
    assert len(got) == len(want) >= 2
    np.testing.assert_allclose(got[np.lexsort(got.T)],
                               want[np.lexsort(want.T)], rtol=1e-3,
                               atol=0.1)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_lsd_core_matches_jax_pallas_path(name):
    img = IMAGES[name]()
    segs, ok, stats = lsd._lsd_core(torch.from_numpy(img))
    assert all(r["unconverged_tiles"] == 0 for r in stats["rounds"])
    _assert_same_segments(segs[ok].numpy(), _jax_pallas_core(img))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_matches_jax_detect(name):
    """Against the JAX package's default ``detect`` (its XLA path)."""
    img = IMAGES[name]()
    _assert_same_segments(lsd.detect(img, device="cpu"), jlsd.detect(img))
