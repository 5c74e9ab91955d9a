"""Inputs shared by the LSD tests of the port, and the port's own LSD checks
that need no JAX (they also run on a machine with a card and no JAX).

``random_sorted_case`` and ``draw_segment`` reproduce the inputs of
``tests/test_lsd_fit.py`` and ``tests/test_lsd.py`` draw for draw, so the
port sees the data the JAX package's tests see.
"""

import math

import numpy as np
import pytest
import torch

import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch.ops import lsd, lsd_cc, lsd_fit
from line3dpp_tpu_torch.ops.special import betainc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread in each module that imports this fixture:
    beside the other test workers, torch's OpenMP threads wait on busy
    cores, which made the CPU detection several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_sorted_case(rng, n=2048, c_cap=256, dump_frac=0.15):
    """Slots sorted by component run, whole runs sent to the dump slot
    ``c_cap``, and random payloads (``test_lsd_fit._random_sorted_case``)."""
    n_runs = 40
    run_of = np.sort(rng.integers(0, n_runs, n))
    dump_runs = rng.uniform(size=n_runs) < dump_frac
    slot = np.where(dump_runs[run_of], c_cap, run_of).astype(np.int32)
    xs = rng.uniform(0, 500, n).astype(np.float32)
    ys = rng.uniform(0, 300, n).astype(np.float32)
    mag = rng.uniform(0.1, 9.0, n).astype(np.float32)
    pix = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return slot, xs, ys, mag, pix


def random_tables(rng, c_cap, n):
    """Per-component (cos t, sin t, cx, cy, gate, center) and per-pixel
    angles, drawn as ``test_lsd_fit.test_gate_moments_equals_gate_then_
    moments`` draws them; returns ((c_cap, 8) tables, (n,) angles)."""
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, c_cap).astype(np.float32)
    tables = np.zeros((c_cap, 8), np.float32)
    tables[:, 0] = np.cos(theta)
    tables[:, 1] = np.sin(theta)
    tables[:, 2] = rng.uniform(0, 500, c_cap)
    tables[:, 3] = rng.uniform(0, 300, c_cap)
    tables[:, 4] = rng.uniform(0.5, 6.0, c_cap)
    tables[:, 5] = rng.uniform(-2.0, 2.0, c_cap)
    return tables, ang


def draw_segment(img, p, q, value=200.0, thickness=1.0):
    """A bright anti-aliased segment on a dark image
    (``test_lsd._draw_segment``)."""
    H, W = img.shape
    n = int(np.hypot(*(np.subtract(q, p))) * 3) + 1
    for t in np.linspace(0, 1, n):
        x = p[0] * (1 - t) + q[0] * t
        y = p[1] * (1 - t) + q[1] * t
        xi, yi = int(round(x)), int(round(y))
        r = int(np.ceil(thickness))
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                yy, xx = yi + dy, xi + dx
                if 0 <= yy < H and 0 <= xx < W:
                    d = np.hypot(xx - x, yy - y)
                    w = max(0.0, 1.0 - max(0.0, d - thickness + 1.0))
                    img[yy, xx] = max(img[yy, xx], value * w)
    return img


TRUTH = [((20.0, 30.0), (180.0, 35.0)), ((30.0, 140.0), (170.0, 60.0)),
         ((100.0, 20.0), (105.0, 150.0))]


def lines_image(seed=0, shape=(160, 200), truth=TRUTH):
    """Noise floor with three drawn segments (``test_lsd``'s image)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 8, size=shape).astype(np.float32)
    for p, q in truth:
        draw_segment(img, p, q)
    return img


def seg_distance(found, p, q, samples=7):
    """Largest distance from a sample point of the true segment p-q to the
    closest found segment (``test_lsd._seg_distance``)."""
    ts = np.linspace(0, 1, samples)[:, None]
    pts = np.array(p)[None] * (1 - ts) + np.array(q)[None] * ts
    a = found[:, :2]
    d = found[:, 2:] - a
    len2 = np.maximum((d * d).sum(-1), 1e-12)
    w = pts[:, None, :] - a[None]
    t = np.clip((w * d[None]).sum(-1) / len2[None], 0, 1)
    cl = a[None] + t[..., None] * d[None]
    return np.linalg.norm(pts[:, None] - cl, axis=-1).min(1).max()


def union_find_labels(angle, active, tol, tile=None):
    """Reference labels by a Python union-find: min flat index of each
    component of the aligned-pixel graph (within tiles when ``tile``)."""
    hp, wp = angle.shape
    parent = np.arange(hp * wp)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    d32 = np.float32
    two_pi, pi = d32(2 * math.pi), d32(math.pi)
    for y, x in zip(*np.nonzero(active)):
        for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
            ny, nx = y + dy, x + dx
            if not (0 <= ny < hp and 0 <= nx < wp and active[ny, nx]):
                continue
            if tile and (ny // tile[0] != y // tile[0]
                         or nx // tile[1] != x // tile[1]):
                continue
            d = d32(abs(angle[y, x] - angle[ny, nx]))
            d = d32(d - two_pi) if d > two_pi else d
            d = d32(two_pi - d) if d > pi else d
            if d <= d32(tol):
                a, b = find(y * wp + x), find(ny * wp + nx)
                parent[max(a, b)] = min(a, b)
    lab = np.array([find(i) for i in range(hp * wp)]).reshape(hp, wp)
    return np.where(active, lab, lsd_cc.INVALID).astype(np.int32)


@pytest.mark.parametrize("tile", [(8, 128), (16, 64)])
def test_k4_plain_is_the_tile_union_find(rng, tile):
    """The plain K4 labels are each tile component's smallest flat index."""
    H, W = 16, 256
    angle = rng.uniform(-math.pi, math.pi, (H, W)).astype(np.float32)
    active = rng.uniform(size=(H, W)) < 0.45
    lab, unconv = lsd_cc.cc_tiles(torch.from_numpy(angle),
                                  torch.from_numpy(active), 0.6, tile)
    want = union_find_labels(angle, active, np.float32(0.6), tile)
    np.testing.assert_array_equal(lab.numpy(), want)
    assert int(unconv) == 0


def test_tile_labels_plus_merge_equal_global_components(rng):
    """Tile labels, border merge and T[label] give the components of the
    whole grid (a blob and random pixels across four tiles)."""
    H, W = 16, 256
    angle = rng.uniform(-0.4, 0.4, (H, W)).astype(np.float32)
    active = rng.uniform(size=(H, W)) < 0.6
    a, m = torch.from_numpy(angle), torch.from_numpy(active)
    lab, _ = lsd_cc.cc_tiles(a, m, 0.25, (8, 128))
    T, n_links = lsd_cc.merge_tile_labels(lab, a, m, 0.25, (8, 128))
    merged = torch.where(lab == lsd_cc.INVALID, lsd_cc.INVALID,
                         T[lab.clamp(max=H * W - 1).long()])
    assert n_links > 0
    np.testing.assert_array_equal(
        merged.numpy(), union_find_labels(angle, active, np.float32(0.25)))


def test_band_counts_and_lsd_options_raise():
    """What still raises: malformed bands.  Every pipeline option has been
    ported (the blocked path last; the name is kept from when it raised),
    so ``view_block`` beside the LSD options constructs.  The LSD options
    run: ``add_image`` under ``Config(lsd_rescue=True,
    lsd_seed_gate=True)`` detects with them and records the detector's
    stats."""
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="bands"):
        lsd_fit.band_counts(z.int(), z, z, z, torch.zeros((1, 8)), 1,
                            bands=((1.0, 2.0),))
    cfg = lt.Config(lsd_rescue=True, view_block=4)
    assert lt.Line3D(cfg, device="cpu").config == cfg
    img = lines_image()
    cam = lt.Camera(np.diag([200.0, 200.0, 1.0]), np.eye(3), np.zeros(3),
                    200, 160)
    pipe = lt.Line3D(lt.Config(lsd_rescue=True, lsd_seed_gate=True,
                               min_image_width=150), device="cpu")
    pipe.add_image(0, cam, img)
    want = lsd.detect(img, rescue=True, seed_gate=True, device="cpu")
    assert len(want) >= 3 and len(pipe.detect_stats) == 1
    assert "n_rescue" in pipe.detect_stats[0]
    lens = np.hypot(want[:, 2] - want[:, 0], want[:, 3] - want[:, 1])
    np.testing.assert_array_equal(
        pipe._views[0].segments,
        want[lens >= cam.diagonal * pipe.config.min_line_length_factor])


def test_betainc_against_float64_series():
    """I_x(a, b) for integer a, b equals the binomial tail
    sum_{j >= a} C(a+b-1, j) x^j (1-x)^(a+b-1-j), summed exactly here."""
    from fractions import Fraction
    from math import comb

    x = Fraction(1, 8)
    pairs = [(1, 1), (1, 30), (5, 3), (12, 40), (40, 12), (70, 300),
             (300, 70), (3, 600)]
    a = torch.tensor([p[0] for p in pairs], dtype=torch.float64)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.float64)
    got = betainc(a, b, 0.125).numpy()
    for (ai, bi), g in zip(pairs, got):
        n = ai + bi - 1
        want = float(sum(comb(n, j) * x**j * (1 - x)**(n - j)
                         for j in range(ai, n + 1)))
        assert g == pytest.approx(want, rel=1e-10, abs=1e-300)


def test_detect_finds_drawn_lines_and_scales_back():
    """The three drawn segments are found, and with ``max_width`` the
    coordinates come back at the original resolution."""
    segs = lsd.detect(lines_image(), device="cpu")
    assert len(segs) >= 3
    for p, q in TRUTH:
        assert seg_distance(segs, p, q) < 4.0, f"missed segment {p}->{q}"
    rng = np.random.default_rng(1)
    wide = rng.uniform(0, 8, size=(200, 300)).astype(np.float32)
    draw_segment(wide, (30.0, 50.0), (270.0, 60.0))
    small = lsd.detect(wide, max_width=150, device="cpu")
    assert len(small) >= 1
    assert seg_distance(small, (30.0, 50.0), (270.0, 60.0)) < 8.0


def test_detect_uint8_rgb_and_empty_images():
    """uint8 frames give the float32 result; RGB is converted to rounded
    luma first; a blank image gives no segments."""
    img = np.clip(lines_image(seed=4), 0, 255).astype(np.uint8)
    a = lsd.detect(img, device="cpu")
    np.testing.assert_array_equal(a, lsd.detect(img.astype(np.float32),
                                                device="cpu"))
    rgb = np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(lsd.detect(rgb, device="cpu"), a)
    assert lsd.detect(np.zeros((64, 96), np.uint8), device="cpu").shape == \
        (0, 4)


def test_add_images_skips_small_and_uses_the_cache(tmp_path, capsys):
    cfg = lt.Config(optimize=False, min_image_width=150)
    cam = lt.Camera(np.diag([200.0, 200.0, 1.0]), np.eye(3), np.zeros(3),
                    200, 160)
    pipe = lt.Line3D(cfg, device="cpu")
    pipe.add_images([(0, cam, lines_image()),
                     (1, cam, np.zeros((100, 120), np.float32))],
                    cache_dir=str(tmp_path))
    assert sorted(pipe._views) == [0] and "too small" in capsys.readouterr()\
        .out
    cached = list(tmp_path.iterdir())
    assert len(cached) == 1
    # a second pipeline reads the stored segments back instead of detecting
    again = lt.Line3D(cfg, device="cpu")
    again.add_image(0, cam, np.zeros((160, 200), np.float32),
                    cache_dir=str(tmp_path))
    np.testing.assert_array_equal(again._views[0].segments,
                                  pipe._views[0].segments)
