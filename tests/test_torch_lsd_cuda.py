"""Kernels K4-K9 and K11 and LSD detection on a CUDA device,
against their plain PyTorch versions.  Marked ``gpu``; each test asks the
``cuda`` fixture for the device and skips where there is none.

On a machine with a card and without JAX (the root conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_lsd_cuda.py
"""

import math

import numpy as np
import pytest
import torch

import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch.ops import kernels, lsd, lsd_cc, lsd_fit, lsd_gather
from line3dpp_tpu_torch.utils import golden, synthetic

from test_torch_lsd_cases import lines_image, random_sorted_case, \
    random_tables

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _big_sorted_case(seed, n=300_000, c=5000):
    """Long runs sorted by slot with whole runs dumped, at detection-like
    sizes; payloads as the detector's (x, y on a 2560 x 1920 grid)."""
    rng = np.random.default_rng(seed)
    run_of = np.sort(rng.integers(0, c, n))
    dump = rng.uniform(size=c) < 0.2
    slot = np.where(dump[run_of], c, run_of).astype(np.int32)
    xs = rng.integers(0, 2560, n).astype(np.float32)
    ys = rng.integers(0, 1920, n).astype(np.float32)
    mag = rng.uniform(5.0, 200.0, n).astype(np.float32)
    pix = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tables, ang = random_tables(rng, c, n)
    tables[:, 2] = rng.uniform(0, 2560, c)
    tables[:, 3] = rng.uniform(0, 1920, c)
    tables[:, 4] = rng.uniform(0.5, 400.0, c)
    return slot, xs, ys, mag, pix, tables, ang, c


@pytest.mark.parametrize("shape,tile,frac", [
    ((16, 256), (8, 128), 0.45), ((256, 1024), (128, 512), 0.6),
    ((640, 896), (128, 128), 0.9)])
def test_k4_equals_plain_bit_for_bit(cuda, shape, tile, frac):
    rng = np.random.default_rng(7)
    angle = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    active = rng.uniform(size=shape) < frac
    a = torch.from_numpy(angle).to(cuda)
    m = torch.from_numpy(active).to(cuda)
    got, unconv = lsd_cc.cc_tiles_cuda(a, m, 0.3, tile)
    want, _ = lsd_cc.cc_tiles_plain(a, m, 0.3, tile)
    assert torch.equal(got, want)
    assert int(unconv) == 0


def test_k5_k6_equal_plain(cuda):
    """The label gathers on a detection-sized grid: exact."""
    rng = np.random.default_rng(8)
    hp, wp, th, tw = 256, 1024, 128, 512
    lab = np.full((hp, wp), lsd_cc.INVALID, np.int32)
    active = rng.uniform(size=(hp, wp)) < 0.4
    ys, xs = np.nonzero(active)
    # an in-tile label of each active pixel
    lab[ys, xs] = ((ys // th * th + rng.integers(0, th, ys.size)) * wp
                   + xs // tw * tw + rng.integers(0, tw, ys.size))
    T = rng.integers(0, hp * wp, hp * wp).astype(np.int32)
    lab_t, T_t = (torch.from_numpy(v).to(cuda) for v in (lab, T))
    dense = lsd_gather.apply_merge_dense_cuda(lab_t, T_t)
    assert torch.equal(dense, lsd_gather.apply_merge_dense_plain(lab_t, T_t))
    idx = torch.nonzero(torch.from_numpy(active).reshape(-1))[:, 0].to(cuda)
    idx = idx[torch.randperm(idx.numel(), device=cuda)]
    flat = dense.reshape(-1)
    assert torch.equal(lsd_gather.gather_labels_cuda(flat, idx),
                       lsd_gather.gather_labels_plain(flat, idx))


def test_fit_kernels_on_the_jax_tests_inputs(cuda):
    """K7, K8, K9, K11 against their plain versions on the random
    sorted-slot case of tests/test_lsd_fit.py."""
    rng = np.random.default_rng(0)
    c = 256
    slot, xs, ys, mag, pix = random_sorted_case(rng)
    tables, ang = random_tables(rng, c, len(slot))
    t = [torch.from_numpy(v).to(cuda) for v in (slot, xs, ys, mag, pix,
                                                tables, ang)]
    slot_t, xs_t, ys_t, mag_t, pix_t, tab_t, ang_t = t
    torch.testing.assert_close(
        lsd_fit.moments_cuda(slot_t, xs_t, ys_t, mag_t, pix_t, c),
        lsd_fit.moments_plain(slot_t, xs_t, ys_t, mag_t, pix_t, c),
        rtol=1e-6, atol=0)
    assert torch.equal(
        lsd_fit.extents_cuda(slot_t, xs_t, ys_t, pix_t, tab_t, c),
        lsd_fit.extents_plain(slot_t, xs_t, ys_t, pix_t, tab_t, c))
    for dump_keep in (True, False):
        for cos_tol in (-2.0, float(np.float32(math.cos(math.radians(22.5))))):
            args = (slot_t, xs_t, ys_t, ang_t, pix_t, tab_t, dump_keep,
                    cos_tol, c)
            np9 = lsd_fit.gate_pixels_cuda(*args)
            assert torch.equal(np9, lsd_fit.gate_pixels_plain(*args))
            np8, mom8 = lsd_fit.gate_moments_cuda(
                slot_t, xs_t, ys_t, ang_t, mag_t, pix_t, tab_t, dump_keep,
                cos_tol, c)
            assert torch.equal(np8, np9)
            torch.testing.assert_close(
                mom8, lsd_fit.moments_plain(slot_t, xs_t, ys_t, mag_t, np9,
                                            c), rtol=1e-6, atol=0)


def test_fit_kernels_at_detection_sizes(cuda):
    """300k pixels, 5000 components: float64 sums agree to 1e-6 relative
    (the last bit of float32); minima exact; at most 1e-5 gate flips
    (cosf/sinf against torch's)."""
    slot, xs, ys, mag, pix, tables, ang, c = _big_sorted_case(3)
    t = [torch.from_numpy(v).to(cuda) for v in (slot, xs, ys, mag, pix,
                                                tables, ang)]
    slot_t, xs_t, ys_t, mag_t, pix_t, tab_t, ang_t = t
    n = len(slot)
    torch.testing.assert_close(
        lsd_fit.moments_cuda(slot_t, xs_t, ys_t, mag_t, pix_t, c),
        lsd_fit.moments_plain(slot_t, xs_t, ys_t, mag_t, pix_t, c),
        rtol=1e-6, atol=0)
    assert torch.equal(
        lsd_fit.extents_cuda(slot_t, xs_t, ys_t, pix_t, tab_t, c),
        lsd_fit.extents_plain(slot_t, xs_t, ys_t, pix_t, tab_t, c))
    cos_gate = float(np.float32(math.cos(math.radians(22.5))))
    args = (slot_t, xs_t, ys_t, ang_t, pix_t, tab_t, True, cos_gate, c)
    np9 = lsd_fit.gate_pixels_cuda(*args)
    assert int((np9 != lsd_fit.gate_pixels_plain(*args)).sum()) <= 1e-5 * n
    np8, _ = lsd_fit.gate_moments_cuda(slot_t, xs_t, ys_t, ang_t, mag_t,
                                       pix_t, tab_t, True, cos_gate, c)
    assert torch.equal(np8, np9)


def test_empty_and_componentless_inputs(cuda):
    z = torch.zeros(0, device=cuda)
    zi = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert lsd_fit.moments_cuda(zi, z, z, z, z, 0).shape == (0, 8)
    slot = torch.full((100,), 0, dtype=torch.int32, device=cuda)
    ones = torch.ones(100, device=cuda)
    tab = torch.zeros((0, 8), device=cuda)
    np8, mom = lsd_fit.gate_moments_cuda(slot, ones, ones, ones, ones, ones,
                                         tab, True, 0.9, 0)
    assert torch.equal(np8, ones) and mom.shape == (0, 8)
    assert lsd_fit.extents_cuda(slot, ones, ones, ones, tab, 0).shape == \
        (0, 4)


def test_detect_on_cuda_matches_cpu(cuda):
    img = lines_image()
    kernels.reset_launches()
    got = lsd.detect(img, device=cuda)
    torch.cuda.synchronize()
    for name in ("cc_tiles", "apply_merge_dense", "gather_labels", "moments",
                 "gate_moments", "gate_pixels", "extents"):
        assert kernels.LAUNCHES[name] > 0, name
    want = lsd.detect(img, device="cpu")
    assert len(got) == len(want)
    np.testing.assert_allclose(got[np.lexsort(got.T)],
                               want[np.lexsort(want.T)], atol=0.05)


def test_add_images_on_cuda_launches_the_detection_kernels(cuda):
    """Four facade views at 1024 x 768 through add_images on the card:
    every detection kernel launches, and the views' segments match the
    CPU run's (1-px mutual endpoint coverage >= 0.98)."""
    quads, _ = synthetic.build_scene()
    cams = synthetic.make_cameras(10)[:4]
    items = [(i, c, synthetic.render(c, quads, 100 + i))
             for i, c in enumerate(cams)]
    cfg = lt.Config(optimize=False, num_neighbors=3)
    kernels.reset_launches()
    pipe = lt.Line3D(cfg)
    pipe.add_images(items)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    assert counts["cc_tiles"] == 12 and counts["moments"] == 12
    assert counts["apply_merge_dense"] == 12 and counts["gather_labels"] == 12
    assert counts["gate_moments"] == 24 and counts["extents"] == 36
    assert counts["gate_pixels"] == 8
    cpu = lt.Line3D(cfg, device="cpu")
    cpu.add_images(items)
    for i in range(4):
        a, b = pipe._views[i].segments, cpu._views[i].segments
        assert abs(len(a) - len(b)) <= 0.02 * len(b)
        assert golden.mutual_coverage(a, b)[0] >= 0.98
