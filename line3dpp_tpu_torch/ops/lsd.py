"""LSD line-segment detection (PyTorch port of ``line3dpp_tpu.ops.lsd``).

The reference vendors the IPOL LSD detector (reference: lsd/lsd.cpp:2025
``LineSegmentDetection``), whose greedy region growing is sequential.  The
JAX package redesigned it as data-parallel passes, and this module runs the
same passes in torch, with hand-written CUDA kernels where the JAX package
has Pallas kernels:

1. ``_grad_compact``: Gaussian blur and 0.8 subsampling, the level-line
   angle field and gradient magnitude (lsd.cpp ``ll_angle``), the pixels
   above the magnitude threshold, padded to whole connected-components
   tiles and compacted in flat-index order.
2. ``_lsd_round``, three times with tolerances 22.5, 11.25 and 5.625
   degrees: connected components of the aligned-pixel graph
   (``ops/lsd_cc``: kernel K4 and the border merge), the merged label of
   every listed pixel in one gather (``ops/lsd_gather``: kernel K6 with the
   map; the JAX package's dense pass K5 is not needed), the active
   pixels sorted by component, the >= 5-pixel run filter, rectangle fits from
   weighted moments and projection extents (``ops/lsd_fit``: kernels K7
   and K11), two density-refine iterations (kernel K8), the NFA test
   (lsd.cpp ``nfa``, with ``ops/special.betainc``), optionally the rescue
   cascade of the rectangles that fail it (lsd.cpp ``rect_improve``: a
   retry at half the angle tolerance and pixel counts in 15 reduced bands,
   one pass of kernel K10's rescue form), and the consumption of accepted
   rectangles'
   pixels (K9's consume form: gate and compact in one pass, one host read
   of the count) before the next round, which runs on the surviving
   pixels only.
3. ``detect`` / ``detect_batch``: grayscale conversion, the optional
   ``max_width`` downscale, upload and the rounds; segments in original
   image coordinates.

The JAX package sizes its device arrays with static caps (active pixels,
components, border links, transfer buffer) and re-runs an image when one
overflows.  Here every array has its exact size, so none of those caps or
re-runs exists.  The options ``rescue``, ``seed_gate``, ``seed_center``,
``side_split`` and ``rect_improve`` are those of the JAX package.  Entry
points run on the CUDA device unless the caller passes
``device="cpu"``, which runs every kernel's plain torch version.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from . import lsd_cc, lsd_fit, lsd_gather
from .special import betainc

# canonical LSD parameters (lsd.cpp defaults; reference lsd/lsd.hpp:80-128)
SCALE = 0.8
SIGMA_SCALE = 0.6
QUANT = 2.0
ANG_TH = 22.5
DENSITY_TH = 0.7
LOG_EPS = 0.0
BIG = lsd_fit.BIG
BIG_ANGLE = lsd_cc.BIG_ANGLE


def _f32(v: float) -> float:
    """``v`` rounded to float32: the value a weak-typed constant takes in
    the JAX package's float32 expressions."""
    return float(np.float32(v))


SCALE_F32 = _f32(SCALE)
PREC = _f32(math.radians(ANG_TH))                  # round-1 link tolerance
RHO = _f32(QUANT / math.sin(math.radians(ANG_TH)))  # magnitude threshold
COS_GATE = _f32(math.cos(math.radians(ANG_TH)))     # region-angle gate
COS_GATE_HALF = _f32(math.cos(math.radians(ANG_TH / 2)))  # the p/2 retry's
P_NFA = ANG_TH / 180.0
PI_F32 = _f32(math.pi)
TWO_PI_F32 = _f32(2.0 * math.pi)


def _rescue_bands() -> tuple:
    """The rescue cascade's 15 reduced bands in the ``s = 2 (w_proj - mid)``
    frame (lsd.cpp rect_improve 1756-1873: width cuts of 0.5 px on both
    sides, on one side, on the other), with each variant's number of
    half-pixel steps and the shift of its centre line in w_proj units."""
    sym = lambda n: (-1.0, 0.5 * n, 1.0, -0.5 * n)
    side_a = lambda n: (-1.0, float(n), 1.0, 0.0)
    side_b = lambda n: (-1.0, 0.0, 1.0, -float(n))
    cuts = (1, 2, 3, 4)
    bands = (tuple(sym(n) for n in cuts) + tuple(side_a(n) for n in cuts)
             + tuple(side_b(n) for n in cuts) + (sym(5), side_a(5), side_b(5)))
    steps = (1, 2, 3, 4) * 3 + (5, 5, 5)
    offs = ((0.0,) * 4 + (0.25, 0.5, 0.75, 1.0)
            + (-0.25, -0.5, -0.75, -1.0) + (0.0, 1.25, -1.25))
    return bands, steps, offs


RESCUE_BANDS, RESCUE_STEPS, RESCUE_OFFS = _rescue_bands()


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, uploaded once."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _gaussian_kernel(sigma: float) -> np.ndarray:
    h = max(1, int(math.ceil(sigma * math.sqrt(2.0 * math.log(1000.0)))))
    x = np.arange(-h, h + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _separable_blur(img: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """Reflect-padded separable blur of a (H, W) float32 image: rows, then
    columns, each a VALID cross-correlation written as a sum of shifted
    products in tap order (the same float32 operations on every device)."""
    K = len(kern)
    h = K // 2
    H, W = img.shape
    x = F.pad(img[None, None], (0, 0, h, h), mode="reflect")[0, 0]
    acc = x[0:H] * float(kern[0])
    for k in range(1, K):
        acc = acc + x[k:k + H] * float(kern[k])
    x = F.pad(acc[None, None], (h, h, 0, 0), mode="reflect")[0, 0]
    acc = x[:, 0:W] * float(kern[0])
    for k in range(1, K):
        acc = acc + x[:, k:k + W] * float(kern[k])
    return acc


def _resize_taps(in_size: int, out_size: int, device) -> tuple:
    """The weights of ``jax.image.resize(method="bilinear")`` along one axis
    (``scale_and_translate``: a triangle kernel widened by 1/scale when
    downsampling, normalised per output sample), in float32 as JAX computes
    them, as ``(index, weight)`` pairs of shape (taps, out_size) holding
    each output sample's nonzero input weights in increasing input order."""
    scale = out_size / in_size
    inv_scale = _f32(1.0 / scale)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.0 * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[
        :, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)                  # (in, out)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, 0.0)
    nz = w != 0
    taps = max(int(nz.sum(0).max()), 1)
    # first nonzero input row of each output sample; the support is
    # contiguous, so taps follow from there
    first = torch.where(nz.any(0), nz.float().argmax(0), 0)
    rows = (first[None, :] + torch.arange(taps)[:, None]).clamp(
        max=in_size - 1)
    wt = torch.gather(w, 0, rows)
    wt = torch.where(first[None, :] + torch.arange(taps)[:, None]
                     < in_size, wt, 0.0)
    return rows.to(device), wt.to(device)


def _bilinear_resize(img: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """``jax.image.resize(img, (out_h, out_w), "bilinear")`` of a (H, W)
    float32 image (antialiased when it shrinks), separably over rows and
    then columns, each output the sum of its taps in input order."""
    H, W = img.shape
    if out_h != H:
        rows, wt = _resize_taps(H, out_h, img.device)
        acc = img[rows[0]] * wt[0][:, None]
        for t in range(1, rows.shape[0]):
            acc = acc + img[rows[t]] * wt[t][:, None]
        img = acc
    if out_w != W:
        cols, wt = _resize_taps(W, out_w, img.device)
        acc = img[:, cols[0]] * wt[0][None, :]
        for t in range(1, cols.shape[0]):
            acc = acc + img[:, cols[t]] * wt[t][None, :]
        img = acc
    return img


def _tile_for(h2: int, w2: int) -> tuple:
    """Connected-components tile of an image: the largest of 256 x 1024 ...
    8 x 128 that keeps the padding under 8%, as the JAX package picks it
    (the tile labels before the border merge depend on it)."""
    def pick(dim, cands, align):
        if dim <= cands[-1]:
            return -(-dim // align) * align
        for c in cands:
            if (-(-dim // c) * c) - dim < 0.08 * dim:
                return c
        return cands[-1]

    return (pick(h2, (256, 128, 64, 32, 16, 8), 8),
            pick(w2, (1024, 512, 256, 128), 128))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _statics(H: int, W: int) -> tuple:
    """(h2, w2, th, tw, hp, wp): subsampled size, CC tile, padded size."""
    h2, w2 = int(round(H * SCALE)), int(round(W * SCALE))
    th, tw = _tile_for(h2, w2)
    return h2, w2, th, tw, _round_up(h2, th), _round_up(w2, tw)


def _grad_compact(img: torch.Tensor):
    """Subsampled level-line field of a (H, W) float32 image.

    Returns ``(angle, used, idx, mag_c, ang_c)``: the padded (hp, wp) angle
    field (``BIG_ANGLE`` in the padding) and used-pixel mask, and the used
    pixels' padded-grid flat indices in increasing order with their
    gradient magnitudes and angles."""
    H, W = img.shape
    h2, w2, th, tw, hp, wp = _statics(H, W)
    blurred = _separable_blur(img, _gaussian_kernel(SIGMA_SCALE / SCALE))
    a = _bilinear_resize(blurred, h2, w2)

    # level-line angle field (lsd.cpp ll_angle): 2x2 gradient masks
    s01 = lsd_cc.shift(a, 0, 1, 0.0)
    s11 = lsd_cc.shift(a, 1, 1, 0.0)
    s10 = lsd_cc.shift(a, 1, 0, 0.0)
    gx = (s01 - a + s11 - s10) * 0.5
    gy = (s10 - a + s11 - s01) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    angle = torch.atan2(gx, -gy)
    used = mag > RHO
    used[h2 - 1, :] = False        # no 2x2 gradient on the last row/column
    used[:, w2 - 1] = False

    # pad to whole tiles at the right and bottom (x, y stay unchanged)
    angle = F.pad(angle, (0, wp - w2, 0, hp - h2), value=BIG_ANGLE)
    mag = F.pad(mag, (0, wp - w2, 0, hp - h2))
    used = F.pad(used, (0, wp - w2, 0, hp - h2))
    idx = torch.nonzero(used.reshape(-1))[:, 0]
    return (angle, used, idx, mag.reshape(-1)[idx],
            angle.reshape(-1)[idx])


def _theta_from_moments(mom: torch.Tensor):
    """Centroid and main direction (max-variance eigenvector of the weighted
    scatter matrix, lsd.cpp ``get_theta``) of every component, its pixel
    count, and the minor eigenvalue: the weighted variance across the
    axis, which the ``side_split`` hollowness test reads."""
    sw, swx, swy, sxx, syy, sxy, npix = mom[:, :7].unbind(1)
    swz = sw.clamp_min(1e-12)
    cx = swx / swz
    cy = swy / swz
    ixx = sxx / swz - cx * cx
    iyy = syy / swz - cy * cy
    ixy = sxy / swz - cx * cy
    diff = ixx - iyy
    disc = torch.sqrt(diff * diff + 4.0 * ixy * ixy)
    lmax_eig = 0.5 * (ixx + iyy + disc)
    theta = torch.where((lmax_eig - ixx).abs() > (lmax_eig - iyy).abs(),
                        torch.atan2(lmax_eig - ixx, ixy),
                        torch.atan2(ixy, lmax_eig - iyy))
    return cx, cy, theta, npix, 0.5 * (ixx + iyy - disc)


def _axis_tables(mom: torch.Tensor):
    """``(tables, npix, var_w)``: the (C, 8) fit tables of the moments
    (cos t, sin t, cx, cy, gate ``BIG``, center 0), the pixel counts and
    the variances across the axis."""
    cx, cy, theta, npix, var_w = _theta_from_moments(mom)
    tables = torch.zeros((mom.shape[0], lsd_fit.TABLE_COLS),
                         dtype=torch.float32, device=mom.device)
    tables[:, 0] = torch.cos(theta)
    tables[:, 1] = torch.sin(theta)
    tables[:, 2] = cx
    tables[:, 3] = cy
    tables[:, 4] = BIG
    return tables, npix, var_w


def _rectangles(tables: torch.Tensor, npix: torch.Tensor,
                ext: torch.Tensor, var_w: torch.Tensor | None = None) -> dict:
    """The fitted rectangles from the tables and the extents (K11)."""
    lmin, wmin, lmax, wmax = ext[:, 0], ext[:, 1], -ext[:, 2], -ext[:, 3]
    length = lmax - lmin
    width = (wmax - wmin).clamp_min(1.0)
    area = length.clamp_min(1.0) * width
    return dict(tables=tables, npix=npix, lmin=lmin, lmax=lmax, wmin=wmin,
                wmax=wmax, length=length, width=width, var_w=var_w,
                density=npix / area.clamp_min(1e-12))


def _with_gate(f: dict, gate: torch.Tensor,
               center: torch.Tensor | None = None) -> torch.Tensor:
    """The fit tables with the band half-width in column 4 and, when given,
    the band's centre on the rectangle normal in column 5 (0 otherwise:
    the band around the fitted axis)."""
    tables = f["tables"].clone()
    tables[:, 4] = gate
    if center is not None:
        tables[:, 5] = center
    return tables


def _refine_gate(f: dict):
    """``(gate, fail)`` of the density refine (lsd.cpp refine /
    reduce_region_radius): a component below the density threshold keeps
    only the pixels within 0.6 of its half-width (at least 0.75) of its
    axis; the others keep all their pixels."""
    half_w = (torch.maximum(f["wmin"].abs(), f["wmax"].abs()) * 0.6
              ).clamp_min(0.75)
    fail = f["density"] < DENSITY_TH
    return torch.where(fail, half_w, BIG), fail


def _consume_tables(f: dict, ok: torch.Tensor,
                    rescue: dict | None = None) -> torch.Tensor:
    """The consume gate: the band of an accepted rectangle, its half-width
    plus 0.75; nothing for the others.  A rescued rectangle consumes only
    its accepted band (half-width ``gate``, centre ``center``): the pixels
    the cut released stay alive for the later rounds."""
    half = torch.maximum(f["wmin"].abs(), f["wmax"].abs()) + 0.75
    gate = torch.where(ok, half, -1.0)
    if rescue is None:
        return _with_gate(f, gate)
    return _with_gate(f, torch.where(rescue["rescued"],
                                     rescue["gate"] + 0.75, gate),
                      rescue["center"])


def _nfa(k_cnt: torch.Tensor, n_area: torch.Tensor, log_ntests: float,
         p: float = P_NFA) -> torch.Tensor:
    """log10 NFA of k aligned pixels in a rectangle of n (lsd.cpp ``nfa``):
    the binomial tail P(X >= k | n, p) = I_p(k, n - k + 1), in float64."""
    n_ = n_area.clamp_min(1.0)
    k_ = torch.minimum(k_cnt, n_)
    tail = betainc(k_.clamp_min(1.0), (n_ - k_ + 1.0).clamp_min(1.0), p)
    return -(log_ntests + torch.log10(tail.clamp_min(1e-300)))


@obs.spanned("lsd.components")
def _pixel_list(angle, active, idx, mag_c, ang_c, tol: float,
                tile: tuple) -> dict:
    """Connected components of the active pixels and the listed pixels
    (all active) sorted by component, with their component slots.

    Returns a dict: ``n`` pixels, ``C`` components (runs of >= 5 pixels),
    ``starts`` (int32 (C,), each component's first sorted position), per
    pixel in sorted order ``slot`` (int32, C for the dump), ``xs``,
    ``ys``, ``idx_s``, ``mag_s``, ``ang_s``, and the counts ``n_links``
    and ``unconverged_tiles`` of the components pass."""
    wp = angle.shape[1]
    dev = angle.device
    n = idx.numel()
    lab_d, unconverged = lsd_cc.cc_tiles(angle, active, tol, tile)
    T, n_links = lsd_cc.merge_tile_labels(lab_d, angle, active, tol, tile)
    lab_c = lsd_gather.gather_merged(lab_d, T, idx)

    # sort the pixels by component label; the stable sort keeps each
    # component's pixels in list order
    key_s, order = torch.sort(lab_c, stable=True)
    idx_s, mag_s, ang_s = idx[order], mag_c[order], ang_c[order]

    # runs of >= 5 pixels become components (npix >= 5 is an acceptance
    # condition); the head of a run carries the flag, which every pixel
    # reads from the latest head at or before it
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = key_s[1:] != key_s[:-1]
    big_head = torch.zeros(n, dtype=torch.bool, device=dev)
    if n > 4:
        big_head[:-4] = new_run[:-4] & (key_s[4:] == key_s[:-4])
    pos = torch.arange(n, device=dev)
    last_head = torch.where(new_run, pos, 0).cummax(0).values
    big_run = big_head[last_head]
    new_run &= big_run
    dlab = torch.cumsum(new_run, 0) - 1
    C = int(new_run.sum())
    return dict(
        n=n, C=C,
        # the run table of kernels K7, K8 and K11: dlab never decreases
        # and first reaches c at component c's head (one launch, no host
        # sync)
        starts=torch.searchsorted(dlab, pos[:C], out_int32=True),
        # component slot per pixel; pixels of short runs go to dump slot C
        slot=torch.where(big_run, dlab, C).to(torch.int32),
        xs=(idx_s % wp).to(torch.float32),
        ys=torch.div(idx_s, wp, rounding_mode="floor").to(torch.float32),
        idx_s=idx_s, mag_s=mag_s, ang_s=ang_s, n_links=n_links,
        unconverged_tiles=int(unconverged.sum()))


def _segment_amax(vals: torch.Tensor, slot: torch.Tensor, C: int,
                  empty) -> torch.Tensor:
    """Per-component maximum of ``vals`` (``empty`` for no pixel)."""
    out = torch.full((C + 1,), empty, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, slot.long(), vals, "amax")
    return out[:C]


def _expand(t: torch.Tensor, slot: torch.Tensor, pad) -> torch.Tensor:
    """Each pixel's entry of a per-component vector, ``pad`` in the dump."""
    return torch.cat([t, t.new_full((1,), pad)])[slot.long()]


def _seed_roots(pl: dict) -> torch.Tensor:
    """The pixels of the largest gradient magnitude in their component
    (lsd.cpp grows a region from its strongest pixel, 790-810)."""
    mmax = _segment_amax(pl["mag_s"], pl["slot"], pl["C"], -BIG)
    return pl["mag_s"] >= _expand(mmax, pl["slot"], BIG)


def _seed_angle_ok(pl: dict) -> torch.Tensor:
    """``seed_gate``: the pixels within ANG_TH of their component's seed
    angle (lsd.cpp admits pixels aligned with the region angle, 1704-1754;
    the seed's level-line angle stands for it).  Dump pixels pass."""
    slot, ang_s, C = pl["slot"], pl["ang_s"], pl["C"]
    root_ang = _segment_amax(torch.where(_seed_roots(pl), ang_s, -BIG),
                             slot, C, -BIG)
    dang = (ang_s - _expand(root_ang, slot, BIG_ANGLE)).abs()
    dang = torch.where(dang > TWO_PI_F32, dang - TWO_PI_F32, dang)
    dang = torch.where(dang > PI_F32, TWO_PI_F32 - dang, dang)
    return (dang <= PREC) | (slot >= C)


def _seed_positions(pl: dict, wp: int):
    """``(x_seed, y_seed, seed_ok)`` per component: its strongest pixel,
    ties in magnitude going to the largest flat index."""
    seed_flat = _segment_amax(
        torch.where(_seed_roots(pl), pl["idx_s"], -1), pl["slot"], pl["C"],
        -1)
    sf = seed_flat.clamp_min(0)
    return ((sf % wp).to(torch.float32),
            torch.div(sf, wp, rounding_mode="floor").to(torch.float32),
            seed_flat >= 0)


def _seed_offset(f: dict, x_seed, y_seed) -> torch.Tensor:
    """The seed's offset from the fitted axis along the rectangle normal."""
    ct, st, cx, cy = f["tables"][:, :4].unbind(1)
    return -(x_seed - cx) * st + (y_seed - cy) * ct


def _first_argmax(t: torch.Tensor) -> torch.Tensor:
    """Index of the maximum along dim 1, the lowest index on ties."""
    pos = torch.arange(t.shape[1], device=t.device)[None, :]
    top = t == t.max(dim=1, keepdim=True).values
    return torch.where(top, pos, t.shape[1]).min(dim=1).values


def _band_tables(f: dict) -> torch.Tensor:
    """The tables K10 reads: the rectangle's mid-line on its normal in
    column 4 and its width in column 5."""
    return _with_gate(f, 0.5 * (f["wmin"] + f["wmax"]), f["width"])


def _rescue(pl: dict, f: dict, pix, ok, log_ntests: float) -> dict:
    """lsd.cpp rect_improve (1756-1873) as one batched cascade over the
    rectangles that pass the density and size tests and fail the NFA: the
    finer precision p/2 over the full band, 5 symmetric width cuts and 5
    cuts of either side in steps of 0.5 px; the variant with the best NFA
    is kept (the first on ties).  Returns ``rescued`` and, for the rescued,
    the accepted band's ``center`` on the rectangle normal (0 = the fitted
    axis) and half-width ``gate`` (0 and -1 for the others); also
    ``attempt`` and the best variant's log NFA ``nfa`` of every
    component."""
    dev = pix.device
    mid = 0.5 * (f["wmin"] + f["wmax"])
    width = f["width"]
    length1 = f["length"].clamp_min(1.0)
    # one pass: the p/2 retry (tighter alignment over the full band, same
    # area) in column 0, then the 15 cuts
    counts = lsd_fit.rescue_counts(
        pl["slot"], pl["xs"], pl["ys"], pl["ang_s"], pix, _band_tables(f),
        pl["C"], _const(RESCUE_BANDS, dev), COS_GATE_HALF,
        pl["starts"])                                             # (C, 16)
    k_half, counts = counts[:, 0], counts[:, 1:]
    steps = _const(RESCUE_STEPS, dev)
    w_v = width[:, None] - 0.5 * steps[None, :]
    nfa_v = _nfa(counts, length1[:, None] * w_v, log_ntests)
    nfa_v = torch.where((w_v > 0.5) & (counts >= 5.0), nfa_v, -BIG)
    nfa_half = torch.where(
        k_half >= 5.0,
        _nfa(k_half, length1 * width, log_ntests, p=P_NFA / 2), -BIG)
    nfa_all = torch.cat([nfa_half[:, None], nfa_v], dim=1)        # (C, 16)
    offs = _const((0.0,) + RESCUE_OFFS, dev)
    off_all = mid[:, None] + offs[None, :]
    w_all = torch.cat([width[:, None], w_v], dim=1)
    best = _first_argmax(nfa_all)[:, None]
    take = lambda t: torch.gather(t, 1, best)[:, 0]
    attempt = (f["npix"] >= 5.0) & ~ok & (f["density"] >= DENSITY_TH)
    nfa_best = take(nfa_all)
    rescued = attempt & (nfa_best > LOG_EPS)
    return dict(rescued=rescued, attempt=attempt, nfa=nfa_best,
                center=torch.where(rescued, take(off_all), 0.0),
                gate=torch.where(rescued, 0.5 * take(w_all), -1.0))


def _rect_improve(pl: dict, f: dict, pix, log_ntests: float) -> torch.Tensor:
    """The older width-retry knob: a rectangle passes when one of 4
    symmetric width cuts (0.5 px steps around its mid-line, endpoints
    unchanged) passes the size, density and NFA tests."""
    counts = lsd_fit.band_counts(pl["slot"], pl["xs"], pl["ys"], pix,
                                 _band_tables(f), pl["C"],
                                 _const(lsd_fit.SYM_BANDS, pix.device),
                                 pl["starts"])
    cuts = _const((1.0, 2.0, 3.0, 4.0), pix.device)
    w_b = f["width"][:, None] - 0.5 * cuts[None, :]
    area_b = f["length"].clamp_min(1.0)[:, None] * w_b
    nfa_b = _nfa(counts, area_b, log_ntests)
    dens_b = counts / area_b.clamp_min(1e-12)
    return ((w_b > 0.5) & (counts >= 5.0) & (dens_b >= DENSITY_TH)
            & (nfa_b > LOG_EPS)).any(dim=1)


@obs.spanned("lsd.round")
def _lsd_round(angle, active, idx, mag_c, ang_c, tol: float, consume: bool,
               tile: tuple, hw2: int, refine_iters: int = 2,
               rect_improve: bool = False, rescue: bool = False,
               seed_gate: bool = False, seed_center: bool = False,
               side_split: bool = False, diag: dict | None = None):
    """One extraction round on the listed pixels (all of them active).

    Returns ``(segs (C, 4), ok (C,), survivors, stats)``: the fitted segment
    of every component in subsampled-to-original coordinates, whether it
    passed, the (idx, mag, ang) of the pixels no accepted rectangle
    consumed (None when ``consume`` is False), and counts.  A ``diag``
    dict receives the per-component tensors of the rescue cascade
    (``_rescue``)."""
    dev = angle.device
    if idx.numel() == 0:
        stats = dict(pixels=0, components=0, border_links=0,
                     unconverged_tiles=0, accepted=0, n_split=0, n_rescue=0,
                     survivors=0 if consume else None)
        return (torch.zeros((0, 4), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev),
                (idx, mag_c, ang_c) if consume else None, stats)
    pl = _pixel_list(angle, active, idx, mag_c, ang_c, tol, tile)
    n, C, slot, xs, ys = pl["n"], pl["C"], pl["slot"], pl["xs"], pl["ys"]
    idx_s, mag_s, ang_s = pl["idx_s"], pl["mag_s"], pl["ang_s"]
    wp = angle.shape[1]

    def fit(mom, pix):
        tables, npix, var_w = _axis_tables(mom)
        return _rectangles(tables, npix,
                           lsd_fit.extents(slot, xs, ys, pix, tables, C,
                                           pl["starts"]),
                           var_w)

    def refit(pix):
        return fit(lsd_fit.moments(slot, xs, ys, mag_s, pix, C,
                                   pl["starts"]), pix)

    def gated_pix(f, gate, pix, dump_keep, center=None, cos_tol=COS_GATE):
        return lsd_fit.gate_pixels(slot, xs, ys, ang_s, pix,
                                   _with_gate(f, gate, center), dump_keep,
                                   cos_tol, C)

    with obs.span("lsd.fit"):
        pix = torch.ones(n, dtype=torch.float32, device=dev)
        if seed_gate:
            # fit the pixels near the seed's angle first, then re-admit every
            # pixel aligned with that axis: a curved tail no longer bends the
            # first fit, and the pixels gated out re-cluster in later rounds
            f0 = refit(pix * _seed_angle_ok(pl).to(torch.float32))
            pix = gated_pix(f0, torch.full((C,), BIG, device=dev), pix, True)
        f = refit(pix)

    with obs.span("lsd.refine"):
        # the density refine: failing components keep only the gated pixels
        # aligned with their axis, and refit
        anchored = (seed_center or side_split) and refine_iters > 0
        if anchored:
            x_seed, y_seed, seed_ok = _seed_positions(pl, wp)
        n_split = 0
        for _ in range(refine_iters):
            gate, fail = _refine_gate(f)
            if side_split:
                # two close parallel lines fused into one component put the
                # axis between them: the w_proj distribution is two bands
                # around a hollow middle (sigma_w / w_ext tends to 1, against
                # 0.58 for a filled band).  Keep the seed's side whole and
                # release the other line for the next round.
                w_ext = torch.maximum(f["wmin"].abs(), f["wmax"].abs())
                hollow = torch.sqrt(f["var_w"].clamp_min(0.0)) >= 0.70 * w_ext
                side_ext = torch.where(_seed_offset(f, x_seed, y_seed) >= 0.0,
                                       f["wmax"], f["wmin"])
                two = fail & hollow & seed_ok & (w_ext >= 1.0)
                n_split += int(two.sum())
                pix = gated_pix(
                    f, torch.where(two, 0.5 * side_ext.abs(), gate), pix,
                    True, center=torch.where(two, 0.5 * side_ext, 0.0))
                f = refit(pix)
            elif seed_center:
                # shrink toward the seed pixel, not the fitted axis (lsd.cpp
                # reduce_region_radius 1296-1358)
                wc = torch.where(fail & seed_ok,
                                 _seed_offset(f, x_seed, y_seed), 0.0)
                pix = gated_pix(f, gate, pix, True, center=wc)
                f = refit(pix)
            else:
                pix, mom = lsd_fit.gate_moments(
                    slot, xs, ys, ang_s, mag_s, pix, _with_gate(f, gate),
                    True, COS_GATE, C, pl["starts"])
                f = fit(mom, pix)

    with obs.span("lsd.nfa"):
        # NFA a-contrario validation: (HW)^{5/2} tests, p = ANG_TH / 180
        log_ntests = 2.5 * math.log10(float(hw2))
        log_nfa = _nfa(f["npix"], f["length"].clamp_min(1.0) * f["width"],
                       log_ntests)
        ok = ((f["npix"] >= 5.0) & (f["density"] >= DENSITY_TH)
              & (log_nfa > LOG_EPS))
        res = None
        if rescue:
            res = _rescue(pl, f, pix, ok, log_ntests)
            ok = ok | res["rescued"]
            if diag is not None:
                diag.update(res)
        if rect_improve:
            ok = ok | _rect_improve(pl, f, pix, log_ntests)

    survivors = None
    if consume:
        with obs.span("lsd.consume"):
            # remove every aligned pixel within an accepted rectangle's band
            survivors = lsd_fit.consume_survivors(
                slot, xs, ys, idx_s, mag_s, ang_s,
                _consume_tables(f, ok, res), COS_GATE, C)

    # endpoints in subsampled coordinates -> original (/SCALE, lsd.cpp
    # 2103-2108); a rescued segment shifts onto its band's centre line
    ct, st, cx, cy = f["tables"][:, :4].unbind(1)
    if res is not None:
        cx = cx - res["center"] * st
        cy = cy + res["center"] * ct
    segs = torch.stack([(cx + f["lmin"] * ct) / SCALE_F32,
                        (cy + f["lmin"] * st) / SCALE_F32,
                        (cx + f["lmax"] * ct) / SCALE_F32,
                        (cy + f["lmax"] * st) / SCALE_F32], dim=-1)
    stats = dict(pixels=n, components=C, border_links=pl["n_links"],
                 unconverged_tiles=pl["unconverged_tiles"],
                 accepted=int(ok.sum()), n_split=n_split,
                 n_rescue=int(res["rescued"].sum()) if rescue else 0,
                 survivors=(int(survivors[0].numel()) if consume else None))
    return segs, ok, survivors, stats


@obs.spanned("lsd.image")
def _lsd_core(img: torch.Tensor, n_rounds: int = 3, refine_iters: int = 2,
              rect_improve: bool = False, rescue: bool = False,
              seed_gate: bool = False, seed_center: bool = False,
              side_split: bool = False, diag: dict | None = None):
    """Detection on a (H, W) float32 grayscale image in [0, 255] on its
    device.  Returns ``(segs (n, 4), ok (n,), stats)`` over the components
    of all rounds, in subsampled-to-original coordinates; ``stats`` holds
    the per-round counts and the totals ``n_split`` and ``n_rescue``.  A
    ``diag`` dict receives the rescue cascade's per-component tensors
    (``_rescue``) over all rounds, in the order of ``segs``."""
    if not 1 <= n_rounds <= 3:
        raise ValueError(f"n_rounds={n_rounds}: the detector runs 1-3 "
                         f"rounds")
    H, W = img.shape
    h2, w2, th, tw, hp, wp = _statics(H, W)
    angle, active, idx, mag_c, ang_c = _grad_compact(img)
    stats = dict(used=int(idx.numel()), grid=(hp, wp), tile=(th, tw),
                 rounds=[])
    # the later rounds re-link what is left at half and a quarter of the
    # tolerance, splitting curved chains into straight pieces
    tols = (PREC, PREC * 0.5, PREC * 0.25)[:n_rounds]
    all_segs, all_ok, round_diags = [], [], []
    for r, tol in enumerate(tols):
        consume = r + 1 < len(tols)
        round_diags.append({})
        segs, ok, surv, st = _lsd_round(
            angle, active, idx, mag_c, ang_c, tol, consume, (th, tw),
            h2 * w2, refine_iters, rect_improve=rect_improve, rescue=rescue,
            seed_gate=seed_gate, seed_center=seed_center,
            side_split=side_split, diag=round_diags[-1])
        all_segs.append(segs)
        all_ok.append(ok)
        stats["rounds"].append(st)
        if consume:
            idx, mag_c, ang_c = surv
            active = torch.zeros(hp * wp, dtype=torch.bool, device=img.device)
            active[idx] = True
            active = active.reshape(hp, wp)
    stats["n_split"] = sum(st["n_split"] for st in stats["rounds"])
    stats["n_rescue"] = sum(st["n_rescue"] for st in stats["rounds"])
    if diag is not None:
        # a round without pixels has no components and no tensors
        filled = [d for d in round_diags if d]
        diag.update({k: torch.cat([d[k] for d in filled])
                     for k in (filled[0] if filled else ())})
    return torch.cat(all_segs), torch.cat(all_ok), stats


def merge_collinear(segs: np.ndarray, angle_tol_deg: float = 2.0,
                    rho_tol: float = 2.5, gap_tol: float = 8.0) -> np.ndarray:
    """Merge collinear, nearly-touching fragments into single segments (host
    numpy, as ``line3dpp_tpu.ops.lsd.merge_collinear``; ``detect`` does not
    call it).

    The multi-round extraction fragments some long edges into pieces; left
    unmerged they rank low in the top-K-by-length selection
    (line3D.cc:320-360) and crowd out true structure.  Segments are hashed by
    quantized line parameters (θ mod π, signed offset ρ) on two offset grids
    each (to dodge quantization boundaries), then chains within a bucket are
    joined greedily along the line when the projection gap is < ``gap_tol``.
    """
    if len(segs) == 0:
        return segs
    segs = np.asarray(segs, np.float64)
    d = segs[:, 2:4] - segs[:, 0:2]
    L = np.maximum(np.hypot(d[:, 0], d[:, 1]), 1e-12)
    theta = np.arctan2(d[:, 1], d[:, 0]) % np.pi          # direction mod pi
    nx, ny = -np.sin(theta), np.cos(theta)
    rho = segs[:, 0] * nx + segs[:, 1] * ny               # line offset

    parent = np.arange(len(segs))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    ang_q = angle_tol_deg * np.pi / 180.0
    for a_off in (0.0, 0.5):
        for r_off in (0.0, 0.5):
            tq = np.floor(theta / ang_q + a_off).astype(np.int64)
            # wrap: theta near pi and near 0 are the same line direction
            tq_mod = tq % max(int(np.pi / ang_q), 1)
            rq = np.floor(rho / rho_tol + r_off).astype(np.int64)
            buckets: dict = {}
            for i, key in enumerate(zip(tq_mod.tolist(), rq.tolist())):
                buckets.setdefault(key, []).append(i)
            for members in buckets.values():
                if len(members) < 2:
                    continue
                m = np.array(members)
                # project onto the mean direction of the bucket
                th = theta[m[0]]
                ux, uy = np.cos(th), np.sin(th)
                p1 = segs[m, 0] * ux + segs[m, 1] * uy
                p2 = segs[m, 2] * ux + segs[m, 3] * uy
                lo = np.minimum(p1, p2)
                hi = np.maximum(p1, p2)
                order = np.argsort(lo)
                for a, b in zip(order[:-1], order[1:]):
                    if lo[b] - hi[a] <= gap_tol:
                        ra, rb = find(m[a]), find(m[b])
                        if ra != rb:
                            parent[rb] = ra

    roots = np.array([find(i) for i in range(len(segs))])

    # refit: extreme endpoints along each chain's length-weighted mean
    # direction, grouped by one sort and reduceat
    order = np.argsort(roots, kind="stable")
    r_s = roots[order]
    starts = np.r_[0, np.flatnonzero(r_s[1:] != r_s[:-1]) + 1]
    sizes = np.diff(np.r_[starts, len(segs)])
    gid = np.repeat(np.arange(len(starts)), sizes)

    s2 = np.add.reduceat(np.sin(2 * theta[order]) * L[order], starts)
    c2 = np.add.reduceat(np.cos(2 * theta[order]) * L[order], starts)
    th_g = 0.5 * np.arctan2(s2, c2)
    ux, uy = np.cos(th_g), np.sin(th_g)

    # both endpoints of every member, laid out contiguously per group
    pts = segs[order].reshape(-1, 2, 2).reshape(-1, 2)      # (2n, 2) xy
    gid2 = np.repeat(gid, 2)
    t = pts[:, 0] * ux[gid2] + pts[:, 1] * uy[gid2]
    po = np.lexsort((t, gid2))
    gstarts2 = 2 * starts
    gends2 = np.r_[gstarts2[1:], 2 * len(segs)] - 1
    pmin = pts[po[gstarts2]]
    pmax = pts[po[gends2]]

    single = sizes == 1
    out = np.concatenate([pmin, pmax], axis=1)
    out[single] = segs[order[starts[single]]]
    return out


def _default_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "LSD detection runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _prepare(image: np.ndarray, max_width: int, device: torch.device):
    """Grayscale conversion (RGB luma, rounded for integer images), upload
    (uint8 images as uint8, cast on the device) and the optional downscale
    to ``max_width`` (line3D.cc:249-372).  Returns the float32 device image
    and the downscale factor."""
    img = np.asarray(image)
    if img.ndim == 3:
        luma = img @ np.array([0.299, 0.587, 0.114])
        if np.issubdtype(img.dtype, np.integer):
            luma = np.rint(luma)
        img = luma.astype(img.dtype)
    if img.dtype != np.uint8:
        img = img.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(img)).to(device).to(
        torch.float32)
    H0, W0 = img.shape
    ds = 1.0
    if max_width > 0 and W0 > max_width:
        ds = W0 / max_width
        t = _bilinear_resize(t, int(round(H0 / ds)), max_width)
    return t, ds


@obs.spanned("lsd.detect")
def detect_batch(images: Sequence[np.ndarray], max_width: int = -1,
                 depth: int = 3, rect_improve: bool = False,
                 rescue: bool = False, n_rounds: int = 3,
                 seed_gate: bool = False, seed_center: bool = False,
                 side_split: bool = False, refine_iters: int = 2, *,
                 device: str | torch.device | None = None,
                 stats: list | None = None) -> list[np.ndarray]:
    """Detect 2D line segments in each image; returns a list of (n, 4)
    float64 arrays [x1 y1 x2 y2] in original image coordinates.

    The parameters are the JAX package's, in its order.  The images run
    one after another on the current stream, each with a few host syncs
    for its exact sizes (active pixels, components, border links,
    survivors).  ``depth`` (>= 1), which bounds the programs in flight in
    the JAX package, has no effect on results there and none here.
    ``rescue`` runs the rescue cascade on the
    rectangles that fail the NFA; ``seed_gate``, ``seed_center`` and
    ``side_split`` anchor the first fit and the density refine on each
    component's strongest pixel; ``rect_improve`` is the older width-retry
    knob.  When ``stats`` is a list, each image's ``_lsd_core`` stats are
    appended to it."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = _default_device(device)
    out = []
    for image in images:
        img, ds = _prepare(image, max_width, device)
        segs, ok, st = _lsd_core(
            img, n_rounds=n_rounds, refine_iters=refine_iters,
            rect_improve=rect_improve, rescue=rescue, seed_gate=seed_gate,
            seed_center=seed_center, side_split=side_split)
        if stats is not None:
            stats.append(st)
        out.append(segs[ok].cpu().numpy().astype(np.float64) * ds)
    return out


def detect(image: np.ndarray, max_width: int = -1, n_rounds: int = 3,
           rescue: bool = False, seed_gate: bool = False,
           seed_center: bool = False, side_split: bool = False,
           refine_iters: int = 2,
           device: str | torch.device | None = None) -> np.ndarray:
    """Detect 2D line segments in one image (see :func:`detect_batch`).

    Mirrors the reference's detectLineSegments flow (line3D.cc:249-372):
    grayscale conversion and optional downscale to ``max_width`` happen
    here; the min-length and top-k filters live in ``Line3D.add_view``."""
    return detect_batch([image], max_width=max_width, n_rounds=n_rounds,
                        rescue=rescue, seed_gate=seed_gate,
                        seed_center=seed_center, side_split=side_split,
                        refine_iters=refine_iters, device=device)[0]
