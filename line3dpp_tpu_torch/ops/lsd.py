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
   every listed pixel (``ops/lsd_gather``: kernels K5 and K6), the active
   pixels sorted by component, the >= 5-pixel run filter, rectangle fits from
   weighted moments and projection extents (``ops/lsd_fit``: kernels K7
   and K11), two density-refine iterations (kernel K8), the NFA test
   (lsd.cpp ``nfa``, with ``ops/special.betainc``), and the consumption of
   accepted rectangles' pixels (kernel K9) before the next round, which
   runs on the surviving pixels only.
3. ``detect`` / ``detect_batch``: grayscale conversion, the optional
   ``max_width`` downscale, upload and the rounds; segments in original
   image coordinates.

The JAX package sizes its device arrays with static caps (active pixels,
components, border links, transfer buffer) and re-runs an image when one
overflows.  Here every array has its exact size, so none of those caps or
re-runs exists.  Only the default configuration is ported: ``rescue``,
``seed_gate``, ``seed_center`` and ``side_split`` raise (ROADMAP item 13).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``, which runs every kernel's plain torch version.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

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
P_NFA = ANG_TH / 180.0


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
    scatter matrix, lsd.cpp ``get_theta``) of every component."""
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
    return cx, cy, theta, npix


def _axis_tables(mom: torch.Tensor):
    """``(tables, npix)``: the (C, 8) fit tables of the moments (cos t,
    sin t, cx, cy, gate ``BIG``, center 0) and the pixel counts."""
    cx, cy, theta, npix = _theta_from_moments(mom)
    tables = torch.zeros((mom.shape[0], lsd_fit.TABLE_COLS),
                         dtype=torch.float32, device=mom.device)
    tables[:, 0] = torch.cos(theta)
    tables[:, 1] = torch.sin(theta)
    tables[:, 2] = cx
    tables[:, 3] = cy
    tables[:, 4] = BIG
    return tables, npix


def _rectangles(tables: torch.Tensor, npix: torch.Tensor,
                ext: torch.Tensor) -> dict:
    """The fitted rectangles from the tables and the extents (K11)."""
    lmin, wmin, lmax, wmax = ext[:, 0], ext[:, 1], -ext[:, 2], -ext[:, 3]
    length = lmax - lmin
    width = (wmax - wmin).clamp_min(1.0)
    area = length.clamp_min(1.0) * width
    return dict(tables=tables, npix=npix, lmin=lmin, lmax=lmax, wmin=wmin,
                wmax=wmax, length=length, width=width,
                density=npix / area.clamp_min(1e-12))


def _with_gate(f: dict, gate: torch.Tensor) -> torch.Tensor:
    tables = f["tables"].clone()
    tables[:, 4] = gate
    return tables


def _refine_tables(f: dict) -> torch.Tensor:
    """The density refine's gate (lsd.cpp refine / reduce_region_radius):
    a component below the density threshold keeps only the pixels within
    0.6 of its half-width (at least 0.75) of its axis; the others keep all
    their pixels."""
    half_w = (torch.maximum(f["wmin"].abs(), f["wmax"].abs()) * 0.6
              ).clamp_min(0.75)
    return _with_gate(f, torch.where(f["density"] < DENSITY_TH, half_w, BIG))


def _consume_tables(f: dict, ok: torch.Tensor) -> torch.Tensor:
    """The consume gate: the band of an accepted rectangle, its half-width
    plus 0.75; nothing for the others."""
    half = torch.maximum(f["wmin"].abs(), f["wmax"].abs()) + 0.75
    return _with_gate(f, torch.where(ok, half, -1.0))


def _nfa(k_cnt: torch.Tensor, n_area: torch.Tensor, log_ntests: float,
         p: float = P_NFA) -> torch.Tensor:
    """log10 NFA of k aligned pixels in a rectangle of n (lsd.cpp ``nfa``):
    the binomial tail P(X >= k | n, p) = I_p(k, n - k + 1), in float64."""
    n_ = n_area.clamp_min(1.0)
    k_ = torch.minimum(k_cnt, n_)
    tail = betainc(k_.clamp_min(1.0), (n_ - k_ + 1.0).clamp_min(1.0), p)
    return -(log_ntests + torch.log10(tail.clamp_min(1e-300)))


def _pixel_list(angle, active, idx, mag_c, ang_c, tol: float,
                tile: tuple) -> dict:
    """Connected components of the active pixels and the listed pixels
    (all active) sorted by component, with their component slots.

    Returns a dict: ``n`` pixels, ``C`` components (runs of >= 5 pixels),
    per pixel in sorted order ``slot`` (int32, C for the dump), ``xs``,
    ``ys``, ``idx_s``, ``mag_s``, ``ang_s``, and the counts ``n_links``
    and ``unconverged_tiles`` of the components pass."""
    wp = angle.shape[1]
    dev = angle.device
    n = idx.numel()
    lab_d, unconverged = lsd_cc.cc_tiles(angle, active, tol, tile)
    T, n_links = lsd_cc.merge_tile_labels(lab_d, angle, active, tol, tile)
    lab_c = lsd_gather.gather_labels(
        lsd_gather.apply_merge_dense(lab_d, T).reshape(-1), idx)

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
        # component slot per pixel; pixels of short runs go to dump slot C
        slot=torch.where(big_run, dlab, C).to(torch.int32),
        xs=(idx_s % wp).to(torch.float32),
        ys=torch.div(idx_s, wp, rounding_mode="floor").to(torch.float32),
        idx_s=idx_s, mag_s=mag_s, ang_s=ang_s, n_links=n_links,
        unconverged_tiles=int(unconverged.sum()))


def _lsd_round(angle, active, idx, mag_c, ang_c, tol: float, consume: bool,
               tile: tuple, hw2: int, refine_iters: int = 2):
    """One extraction round on the listed pixels (all of them active).

    Returns ``(segs (C, 4), ok (C,), survivors, stats)``: the fitted segment
    of every component in subsampled-to-original coordinates, whether it
    passed, the (idx, mag, ang) of the pixels no accepted rectangle
    consumed (None when ``consume`` is False), and counts."""
    dev = angle.device
    if idx.numel() == 0:
        stats = dict(pixels=0, components=0, border_links=0,
                     unconverged_tiles=0, accepted=0,
                     survivors=0 if consume else None)
        return (torch.zeros((0, 4), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev),
                (idx, mag_c, ang_c) if consume else None, stats)
    pl = _pixel_list(angle, active, idx, mag_c, ang_c, tol, tile)
    n, C, slot, xs, ys = pl["n"], pl["C"], pl["slot"], pl["xs"], pl["ys"]
    idx_s, mag_s, ang_s = pl["idx_s"], pl["mag_s"], pl["ang_s"]

    def fit(mom, pix):
        tables, npix = _axis_tables(mom)
        return _rectangles(tables, npix,
                           lsd_fit.extents(slot, xs, ys, pix, tables, C))

    # first fit, then the density refine: failing components keep only the
    # gated pixels aligned with their axis, and refit
    pix = torch.ones(n, dtype=torch.float32, device=dev)
    f = fit(lsd_fit.moments(slot, xs, ys, mag_s, pix, C), pix)
    for _ in range(refine_iters):
        pix, mom = lsd_fit.gate_moments(slot, xs, ys, ang_s, mag_s, pix,
                                        _refine_tables(f), True, COS_GATE, C)
        f = fit(mom, pix)

    # NFA a-contrario validation: (HW)^{5/2} tests, p = ANG_TH / 180
    log_nfa = _nfa(f["npix"], f["length"].clamp_min(1.0) * f["width"],
                   2.5 * math.log10(float(hw2)))
    ok = ((f["npix"] >= 5.0) & (f["density"] >= DENSITY_TH)
          & (log_nfa > LOG_EPS))

    survivors = None
    if consume:
        # remove every aligned pixel within an accepted rectangle's band
        consumed = lsd_fit.gate_pixels(
            slot, xs, ys, ang_s, torch.ones_like(pix), _consume_tables(f, ok),
            False, COS_GATE, C) != 0.0
        alive = ~consumed
        survivors = (idx_s[alive], mag_s[alive], ang_s[alive])

    # endpoints in subsampled coordinates -> original (/SCALE, lsd.cpp
    # 2103-2108)
    ct, st, cx, cy = f["tables"][:, :4].unbind(1)
    segs = torch.stack([(cx + f["lmin"] * ct) / SCALE_F32,
                        (cy + f["lmin"] * st) / SCALE_F32,
                        (cx + f["lmax"] * ct) / SCALE_F32,
                        (cy + f["lmax"] * st) / SCALE_F32], dim=-1)
    stats = dict(pixels=n, components=C, border_links=pl["n_links"],
                 unconverged_tiles=pl["unconverged_tiles"],
                 accepted=int(ok.sum()),
                 survivors=(int(survivors[0].numel()) if consume else None))
    return segs, ok, survivors, stats


def _lsd_core(img: torch.Tensor, n_rounds: int = 3, refine_iters: int = 2):
    """Detection on a (H, W) float32 grayscale image in [0, 255] on its
    device.  Returns ``(segs (n, 4), ok (n,), stats)`` over the components
    of all rounds, in subsampled-to-original coordinates."""
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
    all_segs, all_ok = [], []
    for r, tol in enumerate(tols):
        consume = r + 1 < len(tols)
        segs, ok, surv, st = _lsd_round(angle, active, idx, mag_c, ang_c,
                                        tol, consume, (th, tw), h2 * w2,
                                        refine_iters)
        all_segs.append(segs)
        all_ok.append(ok)
        stats["rounds"].append(st)
        if consume:
            idx, mag_c, ang_c = surv
            active = torch.zeros(hp * wp, dtype=torch.bool, device=img.device)
            active[idx] = True
            active = active.reshape(hp, wp)
    return torch.cat(all_segs), torch.cat(all_ok), stats


def _default_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "LSD detection runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _check_options(rescue, seed_gate, seed_center, side_split) -> None:
    for on, name in ((rescue, "rescue"), (seed_gate, "seed_gate"),
                     (seed_center, "seed_center"),
                     (side_split, "side_split")):
        if on:
            raise NotImplementedError(
                f"LSD option {name}=True is not ported to line3dpp_tpu_torch "
                f"yet (ROADMAP item 13)")


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


def detect_batch(images: Sequence[np.ndarray], max_width: int = -1,
                 n_rounds: int = 3, rescue: bool = False,
                 seed_gate: bool = False, seed_center: bool = False,
                 side_split: bool = False, refine_iters: int = 2,
                 device: str | torch.device | None = None
                 ) -> list[np.ndarray]:
    """Detect 2D line segments in each image; returns a list of (n, 4)
    float64 arrays [x1 y1 x2 y2] in original image coordinates.

    The images run one after another on the current stream, each with a
    few host syncs for its exact sizes (active pixels, components, border
    links, survivors)."""
    _check_options(rescue, seed_gate, seed_center, side_split)
    device = _default_device(device)
    out = []
    for image in images:
        img, ds = _prepare(image, max_width, device)
        segs, ok, _ = _lsd_core(img, n_rounds=n_rounds,
                                refine_iters=refine_iters)
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
