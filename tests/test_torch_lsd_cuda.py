"""Kernels K4-K11 (K6 also with the map, K9 also in its consume form), LSD
detection and line bundling on a CUDA device, against their plain PyTorch
versions.  Marked ``gpu``; each test asks the ``cuda`` fixture for the
device and skips where there is none.

On a machine with a card and without JAX (the root conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_lsd_cuda.py
"""

import ctypes
import importlib.util
import math
import os

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


@pytest.mark.parametrize("shape,tile", [
    ((16, 256), (8, 128)), ((32, 512), (16, 256)), ((256, 1024), (128, 512)),
    ((512, 512), (256, 256)), ((512, 2048), (256, 1024)),
    ((256, 256), (128, 128))], ids=lambda v: "x".join(map(str, v)))
def test_k4_on_every_tile_family(cuda, shape, tile):
    """Every tile shape the detector picks (``lsd._tile_for``), 2 x 2 tiles,
    at a real photo's density with angles that chain across patches."""
    rng = np.random.default_rng(sum(shape) + sum(tile))
    coarse = rng.uniform(-np.pi, np.pi, (shape[0] // 4 + 1, shape[1] // 4 + 1))
    angle = (np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:shape[0], :shape[1]]
             + rng.normal(0, 0.1, shape)).astype(np.float32)
    active = rng.uniform(size=shape) < 0.55
    _k4_equals_plain(cuda, angle, active, tile, lsd.PREC)


def _k4_equals_plain(dev, angle, active, tile, tol):
    a = torch.from_numpy(np.ascontiguousarray(angle)).to(dev)
    m = torch.from_numpy(np.ascontiguousarray(active)).to(dev)
    before = kernels.LAUNCHES["cc_tiles"]
    got, unconv = lsd_cc.cc_tiles(a, m, tol, tile)
    assert kernels.LAUNCHES["cc_tiles"] == before + 1
    want, _ = lsd_cc.cc_tiles_plain(a, m, tol, tile)
    assert torch.equal(got, want)
    assert int(unconv) == 0
    return want


def _snake(hp, wp, tw):
    """A one-pixel path along every other row, turning at alternate ends of
    each tile column: one component per tile that crosses every patch of
    the tile."""
    act = np.zeros((hp, wp), bool)
    act[::2] = True
    for y in range(1, hp, 2):
        end = tw - 1 if (y // 2) % 2 == 0 else 0
        act[y, end::tw] = True
    return act


def _spiral(hp, wp):
    act = np.zeros((hp, wp), bool)
    y0, x0, y1, x1 = 0, 0, hp - 1, wp - 1
    while y0 <= y1 and x0 <= x1:
        act[y0, x0:x1 + 1] = True
        act[y0:y1 + 1, x1] = True
        if y1 > y0 + 1:
            act[y1, x0:x1 + 1] = True
        if x1 > x0 + 1:
            act[y0 + 2:y1 + 1, x0] = True
        if x0 + 2 <= x1:
            act[y0 + 2, x0:x0 + 3] = True
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return act


def _patch_corners(hp, wp, th, tw):
    """Single pixels at every patch corner, and diagonal pairs across the
    corners (up-left and up-right links that leave the patch)."""
    ph, pw = lsd_cc.cc_patch((th, tw))
    act = np.zeros((hp, wp), bool)
    for y0 in range(0, hp, ph):
        for x0 in range(0, wp, pw):
            act[y0, x0] = act[y0 + ph - 1, x0 + pw - 1] = True
            act[y0 + ph - 1, x0] = act[y0, x0 + pw - 1] = True
    for y0 in range(ph, hp, ph):
        for x0 in range(pw, wp, pw):
            act[y0 - 1, x0 - 1] = act[y0, x0] = True
            act[y0 - 1, x0 + 1] = act[y0, x0 + 2] = False
    return act


@pytest.mark.parametrize("case", ["snake", "spiral", "spiral_cut",
                                  "checkerboard",
                                  "wrap", "all", "none", "corners"])
def test_k4_on_adversarial_grids(cuda, case):
    """Components that cross many patch borders and stop at tile borders,
    diagonal-only links, angles at +-pi (angle_diff wraps), everything and
    nothing active, single pixels at the patch corners."""
    hp, wp, tile = 256, 1024, (128, 512)
    yy, xx = np.mgrid[0:hp, 0:wp]
    angle = np.full((hp, wp), 0.5, np.float32)
    if case == "snake":
        active = _snake(hp, wp, tile[1])
    elif case == "spiral":
        active = _spiral(hp, wp)
        tile = (256, 1024)
    elif case == "spiral_cut":              # the same, cut by tile borders
        active = _spiral(hp, wp)
    elif case == "checkerboard":
        active = (yy + xx) % 2 == 0
        angle = (0.2 * ((yy // 3) % 2)).astype(np.float32)
    elif case == "wrap":
        active = np.ones((hp, wp), bool)
        s = np.where((yy + 2 * xx) % 3 == 0, 1.0, -1.0)
        angle = (s * (np.float32(np.pi) - 0.05)).astype(np.float32)
        angle[100:140, :] = 0.0             # a band that links to nothing
    elif case == "all":
        active = np.ones((hp, wp), bool)
    elif case == "none":
        active = np.zeros((hp, wp), bool)
    else:
        active = _patch_corners(hp, wp, *tile)
    want = _k4_equals_plain(cuda, angle, active, tile, lsd.PREC)
    labels = want[torch.from_numpy(active).to(cuda)]
    n_comp = int(torch.unique(labels).numel())
    tiles = (hp // tile[0]) * (wp // tile[1])
    if case in ("snake", "all"):
        assert n_comp == tiles
    if case == "spiral":
        assert n_comp == 1
    if case == "none":
        assert n_comp == 0


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


@pytest.mark.parametrize("order", ["sorted", "shuffled", "offset", "odd",
                                   "empty"])
def test_k6_gather_merged_equals_plain_and_k5_k6(cuda, order):
    """K6's merged gather on a detection-sized grid with INVALID labels
    listed: bit for bit its plain version and K5 then K6; two calls give
    the same bits.  ``offset`` reads a view one index in (no 16-byte
    loads), ``odd`` an odd count."""
    rng = np.random.default_rng(9)
    hp, wp, th, tw = 256, 1024, 128, 512
    lab = np.full((hp, wp), lsd_cc.INVALID, np.int32)
    active = rng.uniform(size=(hp, wp)) < 0.4
    ys, xs = np.nonzero(active)
    lab[ys, xs] = ((ys // th * th + rng.integers(0, th, ys.size)) * wp
                   + xs // tw * tw + rng.integers(0, tw, ys.size))
    T = rng.integers(0, hp * wp, hp * wp).astype(np.int32)
    lab_t, T_t = (torch.from_numpy(v).to(cuda) for v in (lab, T))
    # every third listed pixel has no label
    listed = active | (rng.uniform(size=(hp, wp)) < 0.2)
    idx = torch.nonzero(torch.from_numpy(listed).reshape(-1))[:, 0].to(cuda)
    if order == "shuffled":
        idx = idx[torch.randperm(idx.numel(), device=cuda)]
    elif order == "offset":
        idx = idx[1:]
    elif order == "odd":
        idx = idx[:idx.numel() // 2 * 2 - 1]
    elif order == "empty":
        idx = idx[:0]
    got = lsd_gather.gather_merged_cuda(lab_t, T_t, idx)
    again = lsd_gather.gather_merged_cuda(lab_t, T_t, idx)
    want = lsd_gather.gather_merged_plain(lab_t, T_t, idx)
    k5k6 = lsd_gather.gather_labels_cuda(
        lsd_gather.apply_merge_dense_cuda(lab_t, T_t).reshape(-1), idx)
    assert torch.equal(got, want) and torch.equal(got, k5k6)
    assert torch.equal(got, again)
    if order != "empty":
        assert bool((got == lsd_cc.INVALID).any())
        assert bool((got != lsd_cc.INVALID).any())


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _consume_case(name, cuda):
    """Detector-like lists for K9's consume form: the JAX tests' sorted
    case and the large one with their tables as consume bands; ``all``:
    every band takes its whole component; ``none``: no component
    accepted; ``tiles``: a whole number of the kernel's tiles."""
    if name in ("big", "all", "none", "tiles"):
        slot, xs, ys, mag, _, tables, ang, c = _big_sorted_case(4)
    else:
        rng = np.random.default_rng(5)
        c = 256
        slot, xs, ys, mag, _ = random_sorted_case(rng)
        tables, ang = random_tables(rng, c, len(slot))
    if name == "tiles":
        tile = lsd_fit.CONSUME_THREADS * lsd_fit.consume_items(
            len(slot), _sms(cuda))
        k = len(slot) // tile * tile
        slot, xs, ys, mag, ang = (v[:k] for v in (slot, xs, ys, mag, ang))
    tables = tables.copy()
    tables[::4, 4] = -1.0                   # not accepted
    if name == "all":
        tables[:, 4] = lsd_fit.BIG
    if name == "none":
        tables[:, 4] = -1.0
    rng = np.random.default_rng(len(slot))
    idx_s = np.sort(rng.choice(1 << 23, len(slot), replace=False))
    t = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for v in (slot, xs, ys, idx_s, mag, ang, tables)]
    return t, c


@pytest.mark.parametrize("name", ["small", "big", "all", "none", "tiles"])
def test_k9_consume_equals_gate_and_mask(cuda, name):
    """The consume form equals K9's gate_pixels form (pix = 1, no dump
    pixel kept) followed by the mask, bit for bit, count included; the
    plain version differs in at most 1e-5 n gate flips; two calls give
    the same bits."""
    (slot, xs, ys, idx_s, mag, ang, tab), c = _consume_case(name, cuda)
    cos_tol = -2.0 if name == "all" else float(lsd.COS_GATE)
    n = slot.numel()
    got = lsd_fit.consume_survivors_cuda(slot, xs, ys, idx_s, mag, ang, tab,
                                         cos_tol, c)
    again = lsd_fit.consume_survivors_cuda(slot, xs, ys, idx_s, mag, ang,
                                           tab, cos_tol, c)
    alive = lsd_fit.gate_pixels_cuda(slot, xs, ys, ang, torch.ones_like(xs),
                                     tab, False, cos_tol, c) == 0.0
    for g, a, src in zip(got, again, (idx_s, mag, ang)):
        assert torch.equal(g, src[alive]) and torch.equal(g, a)
    plain = lsd_fit.gate_pixels_plain(slot, xs, ys, ang, torch.ones_like(xs),
                                      tab, False, cos_tol, c) == 0.0
    assert int((alive != plain).sum()) <= 1e-5 * n
    dump = slot == c
    if name == "all":
        assert got[0].numel() == int(dump.sum())
    if name == "none":
        assert got[0].numel() == n
    if name == "tiles":
        tile = lsd_fit.CONSUME_THREADS * lsd_fit.consume_items(n, _sms(cuda))
        assert n % tile == 0 and n > 0


def test_k9_consume_calls_in_a_row(cuda):
    """Lists that grow and shrink, one call after another on the stream
    (a new epoch each, the status words reused or grown), and an empty
    list: each output is the gate and the mask."""
    (slot, xs, ys, idx_s, mag, ang, tab), c = _consume_case("big", cuda)
    for k in (7, 300_000, 2049, 0, 2048 * 40, 1, 150_001):
        args = [v[:k] for v in (slot, xs, ys, idx_s, mag, ang)]
        got = lsd_fit.consume_survivors_cuda(*args, tab, float(lsd.COS_GATE),
                                             c)
        alive = lsd_fit.gate_pixels_cuda(
            args[0], args[1], args[2], args[5], torch.ones_like(args[1]),
            tab, False, float(lsd.COS_GATE), c) == 0.0
        for g, src in zip(got, (args[3], args[4], args[5])):
            assert torch.equal(g, src[alive])


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


def _k11_runs(lengths, dump, seed=0):
    """A slot list of runs of the given lengths, ``dump[c]`` dump pixels
    before run c, random payloads and tables as the detector's."""
    rng = np.random.default_rng(seed)
    C = len(lengths)
    slot = []
    for c, (m, d) in enumerate(zip(lengths, dump)):
        slot += [C] * d + [c] * m
    slot = np.array(slot + [C] * 3, np.int32)
    n = len(slot)
    xs = rng.integers(0, 2560, n).astype(np.float32)
    ys = rng.integers(0, 1920, n).astype(np.float32)
    pix = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tables, _ = random_tables(rng, C, n)
    tables[:, 2] = rng.uniform(0, 2560, C)
    tables[:, 3] = rng.uniform(0, 1920, C)
    return slot, xs, ys, pix, tables, C


def _k11_equal(dev, slot, xs, ys, pix, tables, C):
    t = [torch.from_numpy(v).to(dev) for v in (slot, xs, ys, pix, tables)]
    want = lsd_fit.extents_plain(*t, C)
    starts = lsd_fit.run_starts(t[0], C)
    for given in (None, starts):
        got = lsd_fit.extents_cuda(*t, C, starts=given)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return want


@pytest.mark.parametrize("layout", ["boundaries", "long", "short"])
def test_k11_runs_across_warps_and_blocks(cuda, layout):
    """Runs that start and end on and next to the kernel's thread (8
    pixels), warp (256), tile (2048) and chunk (4096) borders, runs longer
    than several chunks, and many short runs; all bit-equal to the plain
    version, with the run table given and built by the wrapper."""
    rng = np.random.default_rng(1)
    if layout == "boundaries":
        lengths, dump = [], []
        for edge in (8, 256, 2048, 4096, 8192):
            for d in (-1, 0, 1):
                lengths.append(edge + d)
                dump.append(int(rng.integers(0, 3)))
    elif layout == "long":
        lengths = [20000, 5, 4096 * 3 + 7, 9000]
        dump = [4093, 0, 11, 4096]
    else:
        lengths = list(rng.integers(5, 70, 6000))
        dump = list(rng.integers(0, 6, 6000) * (rng.uniform(size=6000) < 0.5))
    _k11_equal(cuda, *_k11_runs(lengths, dump))


def test_k11_small_empty_and_pixless_components(cuda):
    """A 5-pixel component, a component whose pixels all have pix == 0
    (BIG), components with no pixel in a built run table (BIG), and a
    component at the very end of the list."""
    slot, xs, ys, pix, tables, C = _k11_runs([5, 40, 300, 7], [2, 0, 9, 1])
    pix[slot == 1] = 0.0
    slot = slot[:-3]                      # component 3 ends the list
    xs, ys, pix = xs[:-3], ys[:-3], pix[:-3]
    want = _k11_equal(cuda, slot, xs, ys, pix, tables, C)
    assert (want[1] == lsd_fit.BIG).all() and (want[0] != lsd_fit.BIG).all()
    # components 1 and 4 have no pixel: slots renamed around them
    slot2 = np.where(slot >= 1, slot + 1, slot).astype(np.int32)
    slot2 = np.where(slot == C, C + 2, slot2).astype(np.int32)
    tables2 = np.concatenate([tables[:1], tables[:1], tables[1:],
                              tables[:1]])
    want2 = _k11_equal(cuda, slot2, xs, ys, pix, tables2, C + 2)
    assert (want2[1] == lsd_fit.BIG).all() and (want2[C + 1] ==
                                                 lsd_fit.BIG).all()


def test_k11_signed_zero_at_the_centre(cuda):
    """A pixel on the component's centre with ct < 0 and st < 0 projects to
    l = -0.0 and -w = -0.0; the kernel orders -0.0 below +0.0 and returns
    the plain version's signed zeros."""
    slot, xs, ys, pix, tables, C = _k11_runs([3, 20], [0, 1])
    tables[0, :4] = (-0.6, -0.8, 100.0, 200.0)
    xs[:3], ys[:3], pix[:3] = 100.0, 200.0, (1.0, 1.0, 0.0)
    want = _k11_equal(cuda, slot, xs, ys, pix, tables, C)
    assert want[0].tolist() == [0.0, 0.0, 0.0, 0.0]
    assert torch.signbit(want[0]).tolist() == [True, False, False, True]


def test_k11_with_the_detectors_run_table(cuda):
    """On a detection's round-1 list: the run table of _pixel_list gives
    what the built one and the plain version give."""
    img, _ = lsd._prepare(lines_image(), -1, cuda)
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    pl = lsd._pixel_list(*lsd._grad_compact(img), lsd.PREC, (th, tw))
    slot, C = pl["slot"], pl["C"]
    assert C > 3
    assert torch.equal(pl["starts"], lsd_fit.run_starts(slot, C))
    rng = np.random.default_rng(2)
    tables = torch.from_numpy(random_tables(rng, C, 1)[0]).to(cuda)
    pix = torch.ones(pl["n"], device=cuda)
    args = (slot, pl["xs"], pl["ys"], pix, tables, C)
    want = lsd_fit.extents_plain(*args)
    assert torch.equal(lsd_fit.extents_cuda(*args, starts=pl["starts"]),
                       want)
    assert torch.equal(lsd_fit.extents_cuda(*args), want)


def test_k11_refuses_a_split_component_without_a_run_table(cuda):
    """A component in two runs (dump pixels or another component between
    them): the wrapper raises where the kernel would miss the second run;
    the plain version takes any order."""
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(random_tables(rng, 2, 1)[0]).to(cuda)
    for order in ([0, 0, 2, 0, 1, 1], [0, 0, 1, 1, 0]):
        slot = torch.tensor(order, dtype=torch.int32, device=cuda)
        ones = torch.ones(len(order), device=cuda)
        with pytest.raises(ValueError, match="component 0 has 2 runs"):
            lsd_fit.extents_cuda(slot, ones, ones, ones, tables, 2)
        assert (lsd_fit.extents_plain(slot, ones, ones, ones, tables, 2)
                != lsd_fit.BIG).all()


def _k78_equal(dev, slot, xs, ys, pix, tables, C, seed=0):
    """K7 and K8 with the run table given and built: sums within 1e-6
    (relative) of the plain version's, K8's newpix equal to K9's and its
    sums those of K9's pixels, two calls equal bit for bit."""
    rng = np.random.default_rng(seed)
    n = len(slot)
    mag = rng.uniform(5.0, 200.0, n).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    t = [torch.from_numpy(v).to(dev) for v in (slot, xs, ys, mag, pix,
                                               tables, ang)]
    slot_t, xs_t, ys_t, mag_t, pix_t, tab_t, ang_t = t
    bits = lambda x: x.view(torch.int32)
    want = lsd_fit.moments_plain(slot_t, xs_t, ys_t, mag_t, pix_t, C)
    starts = lsd_fit.run_starts(slot_t, C)
    cos_gate = float(np.float32(math.cos(math.radians(22.5))))
    np9 = lsd_fit.gate_pixels_cuda(slot_t, xs_t, ys_t, ang_t, pix_t, tab_t,
                                   True, cos_gate, C)
    want8 = lsd_fit.moments_plain(slot_t, xs_t, ys_t, mag_t, np9, C)
    for given in (None, starts):
        got = lsd_fit.moments_cuda(slot_t, xs_t, ys_t, mag_t, pix_t, C,
                                   starts=given)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        assert torch.equal(bits(got), bits(lsd_fit.moments_cuda(
            slot_t, xs_t, ys_t, mag_t, pix_t, C, starts=given)))
        args = (slot_t, xs_t, ys_t, ang_t, mag_t, pix_t, tab_t, True,
                cos_gate, C)
        np8, mom8 = lsd_fit.gate_moments_cuda(*args, starts=given)
        assert torch.equal(np8, np9)
        torch.testing.assert_close(mom8, want8, rtol=1e-6, atol=0)
        np8b, mom8b = lsd_fit.gate_moments_cuda(*args, starts=given)
        assert torch.equal(np8b, np8) and torch.equal(bits(mom8b),
                                                      bits(mom8))
    return want


@pytest.mark.parametrize("layout", ["boundaries", "long", "short", "empty"])
def test_k7_k8_runs_across_threads_warps_and_tiles(cuda, layout):
    """Runs that start and end on and next to the kernels' thread (4
    pixels), warp (128) and tile (1024 and 2048, the two layouts) borders,
    runs of several tiles, many short runs, and components with no pixel or
    none with pix != 0."""
    rng = np.random.default_rng(4)
    span = lsd_fit.FIT_THREADS * lsd_fit.FIT_ITEMS
    if layout == "boundaries":
        lengths, dump = [], []
        for edge in (lsd_fit.FIT_ITEMS, 32 * lsd_fit.FIT_ITEMS, span,
                     2 * span, 4 * span):
            for d in (-1, 0, 1):
                lengths.append(edge + d)
                dump.append(int(rng.integers(0, 3)))
    elif layout == "long":
        lengths = [20000, 5, span * 3 + 7, 9000, 7208]
        dump = [span - 3, 0, 11, span, 1]
    elif layout == "short":
        lengths = list(rng.integers(5, 70, 6000))
        dump = list(rng.integers(0, 6, 6000) * (rng.uniform(size=6000) < 0.5))
    else:
        lengths, dump = [5, 40, 300, 7, 2 * span + 1], [2, 0, 9, 1, 3]
    slot, xs, ys, pix, tables, C = _k11_runs(lengths, dump, seed=5)
    if layout == "empty":
        pix[slot == 1] = 0.0
        # components 1 and 5 have no pixel (slots renamed around them),
        # component 2 no pixel with pix != 0
        slot = np.where(slot >= 1, slot + 1, slot)
        slot = np.where(slot >= 5, slot + 1, slot).astype(np.int32)
        tables = np.concatenate([tables, tables[:2]])
        C += 2
    want = _k78_equal(cuda, slot, xs, ys, pix, tables, C)
    if layout == "empty":
        assert not want[[1, 2, 5]].any()
        assert (want[[0, 3, 4, 6], 6] > 0).all()


def test_k7_k8_with_the_detectors_run_table(cuda):
    """On a detection's round-1 list: the run table of _pixel_list gives
    what the built one and the plain version give."""
    img, _ = lsd._prepare(lines_image(), -1, cuda)
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    pl = lsd._pixel_list(*lsd._grad_compact(img), lsd.PREC, (th, tw))
    slot, C, n = pl["slot"], pl["C"], pl["n"]
    rng = np.random.default_rng(6)
    tables = torch.from_numpy(random_tables(rng, C, 1)[0]).to(cuda)
    pix = torch.ones(n, device=cuda)
    args = (slot, pl["xs"], pl["ys"], pl["mag_s"], pix, C)
    want = lsd_fit.moments_plain(*args)
    for given in (pl["starts"], None):
        torch.testing.assert_close(lsd_fit.moments_cuda(*args, given), want,
                                   rtol=1e-6, atol=0)
    args8 = (slot, pl["xs"], pl["ys"], pl["ang_s"], pl["mag_s"], pix,
             tables, True, lsd.COS_GATE, C)
    np8, mom8 = lsd_fit.gate_moments_cuda(*args8, pl["starts"])
    np8b, mom8b = lsd_fit.gate_moments_cuda(*args8)
    assert torch.equal(np8, np8b) and torch.equal(mom8, mom8b)
    assert torch.equal(np8, lsd_fit.gate_pixels_cuda(
        slot, pl["xs"], pl["ys"], pl["ang_s"], pix, tables, True,
        lsd.COS_GATE, C))


def test_k8_gate_sincosf_equals_k9_sinf_cosf_on_every_float32(cuda):
    """K8 gates with sincosf, K9 with sinf and cosf: the bits agree for all
    2^32 float32 angles (chip_smoke.SINCOS_CHECK_CU), so K8's newpix is
    K9's on any input."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.sincos_differences(cuda) == (0, -1)


def test_k7_k8_take_only_the_two_layouts(cuda):
    """The kernels launch at the threads a block fit_threads chooses and
    refuse any other count."""
    ones = torch.ones(8, device=cuda)
    slot = torch.zeros(8, dtype=torch.int32, device=cuda)
    starts = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.empty((1, 8), device=cuda)
    p, stream = kernels.ptr, kernels.stream(cuda)
    for threads in (lsd_fit.FIT_THREADS, lsd_fit.FIT_THREADS_LONG, 128, 0):
        rc = kernels.library().l3d_moments(
            p(slot), p(ones), p(ones), p(ones), p(ones), p(starts), 8, 1,
            threads, p(out), stream)
        assert (rc == 0) == (threads in (lsd_fit.FIT_THREADS,
                                         lsd_fit.FIT_THREADS_LONG))
    torch.cuda.synchronize()
    assert out[0, 6] == 8 and out[0, 0] == 8


def test_k10_takes_only_the_two_spans(cuda):
    """K10 launches at the spans count_span chooses and refuses any other
    span, and status words too few for the span."""
    n = 300
    slot = torch.zeros(n, dtype=torch.int32, device=cuda)
    ones = torch.ones(n, device=cuda)
    tables = torch.zeros((1, 8), device=cuda)
    tables[0, 0], tables[0, 5] = 1.0, 1e4
    bands = torch.tensor(lsd_fit.SYM_BANDS, device=cuda)
    starts = torch.zeros(1, dtype=torch.int32, device=cuda)
    words = torch.zeros(64, dtype=torch.int64, device=cuda)
    p, stream = kernels.ptr, kernels.stream(cuda)
    want = lsd_fit.band_counts_plain(slot, ones, ones, ones, tables, 1)
    for epoch, (span, n_words) in enumerate(
            ((lsd_fit.COUNT_SPAN_SHORT, 24), (lsd_fit.COUNT_SPAN_LONG, 16),
             (lsd_fit.COUNT_SPAN_SHORT, 16), (64, 64), (512, 64)), 1):
        out = torch.full((1, 4), -1.0, device=cuda)
        rc = kernels.library().l3d_band_counts(
            p(slot), p(ones), p(ones), None, p(ones), p(tables), p(bands),
            p(starts), n, 1, 4, 0, span, ctypes.c_float(0.0), p(words),
            n_words, epoch, p(out), stream)
        ok = span in (lsd_fit.COUNT_SPAN_SHORT, lsd_fit.COUNT_SPAN_LONG) and (
            -(-n // span) * lsd_fit.MAX_BANDS // 2 <= n_words)
        assert (rc == 0) == ok
        torch.cuda.synchronize()
        assert torch.equal(out, want) == ok


def test_k7_k8_refuse_a_split_component_without_a_run_table(cuda):
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(random_tables(rng, 2, 1)[0]).to(cuda)
    slot = torch.tensor([0, 0, 2, 0, 1, 1], dtype=torch.int32, device=cuda)
    ones = torch.ones(6, device=cuda)
    with pytest.raises(ValueError, match="component 0 has 2 runs"):
        lsd_fit.moments_cuda(slot, ones, ones, ones, ones, 2)
    with pytest.raises(ValueError, match="component 0 has 2 runs"):
        lsd_fit.gate_moments_cuda(slot, ones, ones, ones, ones, ones, tables,
                                  True, 0.9, 2)


def _band_tables(rng, tables):
    """Columns 4 and 5 as K10 reads them: band mid-line and width."""
    t = tables.copy()
    t[:, 4] = rng.uniform(-3, 3, len(t))
    t[:, 5] = rng.uniform(0.5, 12.0, len(t))
    return t


def _k10_cases(rng):
    """K10's inputs: the random sorted-slot case of tests/test_lsd_fit.py
    and a detection-sized one (300k pixels moved to within 8 px of their
    component's axis and angles near it, so the bands and the p/2 column
    hold pixels), as (slot, xs, ys, ang, pix, tables, C)."""
    slot, xs, ys, _, pix = random_sorted_case(rng)
    tables, ang = random_tables(rng, 256, len(slot))
    small = (slot, xs, ys, ang, pix, _band_tables(rng, tables), 256)
    slot, xs, ys, _, pix, tables, _, c = _big_sorted_case(4)
    tables = _band_tables(rng, tables)
    row = tables[np.minimum(slot, c - 1)]
    along, across = rng.uniform(-60, 60, len(slot)), rng.uniform(-8, 8,
                                                                 len(slot))
    xs = np.rint(row[:, 2] + along * row[:, 0] - across * row[:, 1]).astype(
        np.float32)
    ys = np.rint(row[:, 3] + along * row[:, 1] + across * row[:, 0]).astype(
        np.float32)
    ang = (np.arctan2(row[:, 1], row[:, 0])
           + rng.normal(0.0, 0.3, len(slot))).astype(np.float32)
    return small, (slot, xs, ys, ang, pix, tables, c)


@pytest.mark.parametrize("bands", [lsd_fit.SYM_BANDS, lsd.RESCUE_BANDS,
                                   lsd.RESCUE_BANDS + lsd_fit.SYM_BANDS[:1]],
                         ids=["sym4", "rescue15", "full16"])
def test_k10_equals_plain_exactly(cuda, bands):
    """K10 on the cases of ``_k10_cases``: integer counts, equal to the
    plain version, one launch a call, with the run table given or built,
    and the same in a second call."""
    for slot, xs, ys, _, pix, tables, c in _k10_cases(
            np.random.default_rng(0)):
        t = [torch.from_numpy(v).to(cuda) for v in (slot, xs, ys, pix,
                                                    tables)]
        before = kernels.LAUNCHES["band_counts"]
        got = lsd_fit.band_counts(*t, c, bands)
        assert kernels.LAUNCHES["band_counts"] == before + 1
        want = lsd_fit.band_counts_plain(*t, c, bands)
        assert got.shape == (c, len(bands)) and got.dtype == torch.float32
        assert torch.equal(got, want)
        starts = lsd_fit.run_starts(t[0], c)
        assert torch.equal(lsd_fit.band_counts(*t, c, bands, starts), got)
        assert torch.equal(got.cpu(), lsd_fit.band_counts(
            *[v.cpu() for v in t], c, bands))
    assert float(got.sum()) > 1e5


def test_k10_rescue_counts_equal_plain_exactly(cuda):
    """K10's rescue form (the p/2 column and the 15 bands, one launch) on
    the cases of ``_k10_cases``, a list whose components are empty or
    dump only, and an empty list: equal to its plain version, and to
    ``band_counts`` in the bands' columns; the same in a second call."""
    cases = list(_k10_cases(np.random.default_rng(1)))
    n = 3000
    slot = np.full(n, 9, np.int32)
    slot[100:1400] = 2
    slot[2000:2900] = 6
    rng = np.random.default_rng(2)
    cases.append((slot, rng.integers(0, 500, n).astype(np.float32),
                  rng.integers(0, 300, n).astype(np.float32),
                  rng.uniform(-np.pi, np.pi, n).astype(np.float32),
                  np.ones(n, np.float32),
                  _band_tables(rng, random_tables(rng, 9, n)[0]), 9))
    z = np.zeros(0, np.float32)
    cases.append((np.zeros(0, np.int32), z, z, z, z,
                  _band_tables(rng, random_tables(rng, 4, 0)[0]), 4))
    sums = []
    for slot, xs, ys, ang, pix, tables, c in cases:
        t = [torch.from_numpy(v).to(cuda) for v in (slot, xs, ys, ang, pix,
                                                    tables)]
        args = (*t, c, lsd.RESCUE_BANDS, lsd.COS_GATE_HALF)
        before = kernels.LAUNCHES["rescue_counts"]
        got = lsd_fit.rescue_counts(*args, lsd_fit.run_starts(t[0], c))
        assert kernels.LAUNCHES["rescue_counts"] == before + 1
        want = lsd_fit.rescue_counts_plain(*args)
        assert got.shape == (c, 16) and got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(lsd_fit.rescue_counts(*args), got)
        assert torch.equal(got[:, 1:], lsd_fit.band_counts(
            t[0], t[1], t[2], t[4], t[5], c, lsd.RESCUE_BANDS))
        sums.append(got.sum(0))
    # every column holds pixels at the detection size
    assert bool((sums[1] > 0).all())


def test_rescue_detection_on_cuda_matches_cpu(cuda):
    """Facade view 4 at 512 x 384 (4 rescued rectangles on the CPU) with
    every option that reaches K10: the card rescues the same number and
    finds the same segments (atol 0.05 px)."""
    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=512, height=384)[4]
    img = synthetic.render(cam, quads, seed=104, ss=1)
    for opts in (dict(rescue=True), dict(rect_improve=True),
                 dict(rescue=True, seed_gate=True, side_split=True)):
        kernels.reset_launches()
        st_g, st_c = [], []
        got = lsd.detect_batch([img], device=cuda, stats=st_g, **opts)[0]
        # three rounds: the rescue form under rescue, the 4-band form
        # under rect_improve
        n_rescue = 3 if opts.get("rescue") else 0
        assert kernels.LAUNCHES["rescue_counts"] == n_rescue
        assert kernels.LAUNCHES["band_counts"] == 3 - n_rescue
        if opts == dict(rescue=True):
            # the p/2 retry is a column of K10's rescue form: no K9 gate
            assert kernels.LAUNCHES["gate_pixels"] == 0
        want = lsd.detect_batch([img], device="cpu", stats=st_c, **opts)[0]
        assert st_g[0]["n_rescue"] == st_c[0]["n_rescue"]
        assert st_g[0]["n_split"] == st_c[0]["n_split"]
        if "rescue" in opts and len(opts) == 1:
            assert st_g[0]["n_rescue"] >= 3
        assert len(got) == len(want)
        d = np.abs(got[:, None] - want[None]).max(-1)
        assert d.min(1).max() <= 0.05 and d.min(0).max() <= 0.05


def test_bundling_on_cuda_matches_cpu_and_repeats(cuda):
    """Views 0-5 under the default Config() on the card against the CPU
    run (count_f1 >= 0.99 at 0.1% scene scale), and two LM runs on the card
    give the same parameters bit for bit."""
    from line3dpp_tpu_torch.ops import bundling
    from line3dpp_tpu_torch.utils.testdata import load_views

    views = load_views(range(6))
    out = []
    cap = {}
    for dev in (cuda, "cpu"):
        pipe = lt.Line3D(lt.Config(max_line_segments=800, num_neighbors=4),
                         device=dev)
        for v in views:
            pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width,
                                              v.height), v.segments)
        pipe.match_images()
        out.append([l.segments3d for l in pipe.reconstruct_3d_lines()])
    assert abs(len(out[0]) - len(out[1])) <= 1 and len(out[1]) > 100
    scale = golden.scene_scale(np.concatenate(out[1]))
    assert golden.line_match_metrics(out[0], out[1], 1e-3 * scale)[
        "count_f1"] >= 0.99

    rng = np.random.default_rng(2)
    C, O = 300, 4000
    oc = torch.from_numpy(rng.integers(0, C, O)).to(cuda)
    P1 = torch.from_numpy(rng.normal(size=(C, 3)).astype(np.float32) * 3)
    P2 = P1 + torch.from_numpy(rng.normal(size=(C, 3)).astype(np.float32))
    m, v = bundling.plucker_from_endpoints(P1.to(cuda), P2.to(cuda))
    s, w = bundling.params_from_plucker(m, v)
    params0 = torch.cat([s, w[:, None]], 1)
    eye = torch.eye(3, device=cuda).expand(O, 3, 3).contiguous()
    obs = (eye, eye, torch.randn((O, 3), device=cuda) * 0.1,
           torch.rand((O, 3), device=cuda), torch.rand((O, 3), device=cuda),
           torch.nn.functional.normalize(torch.randn((O, 2), device=cuda),
                                         dim=1))
    a = bundling.lm_optimize(params0, oc, *obs, num_clusters=C, iterations=20)
    b = bundling.lm_optimize(params0, oc, *obs, num_clusters=C, iterations=20)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    cost = bundling.lm_cost(a, oc, *obs, num_clusters=C)
    assert float(cost.sum()) < float(bundling.lm_cost(
        params0, oc, *obs, num_clusters=C).sum())


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
    assert lsd_fit.band_counts_cuda(slot, ones, ones, ones, tab, 0).shape == \
        (0, 4)
    assert lsd_fit.rescue_counts_cuda(slot, ones, ones, ones, ones, tab, 0,
                                      lsd.RESCUE_BANDS,
                                      lsd.COS_GATE_HALF).shape == (0, 16)


def test_detect_on_cuda_matches_cpu(cuda):
    img = lines_image()
    kernels.reset_launches()
    got = lsd.detect(img, device=cuda)
    torch.cuda.synchronize()
    for name in ("cc_tiles", "gather_merged", "moments", "gate_moments",
                 "consume_survivors", "extents"):
        assert kernels.LAUNCHES[name] > 0, name
    # the detector runs no dense merge pass and no separate consume gate
    for name in ("apply_merge_dense", "gather_labels", "gate_pixels"):
        assert kernels.LAUNCHES[name] == 0, name
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
    assert counts["gather_merged"] == 12 and counts["apply_merge_dense"] == 0
    assert counts["gather_labels"] == 0
    assert counts["gate_moments"] == 24 and counts["extents"] == 36
    assert counts["consume_survivors"] == 8 and counts["gate_pixels"] == 0
    cpu = lt.Line3D(cfg, device="cpu")
    cpu.add_images(items)
    for i in range(4):
        a, b = pipe._views[i].segments, cpu._views[i].segments
        assert abs(len(a) - len(b)) <= 0.02 * len(b)
        assert golden.mutual_coverage(a, b)[0] >= 0.98
