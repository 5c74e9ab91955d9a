"""2D collinearity analysis (optional, ``collinearity_t > 0``).

Per image, segment pairs that do not overlap along their common direction
and whose four mutual endpoint-to-line distances all stay below a pixel
threshold are "collinear"; such pairs contribute extra affinity edges so
broken 2D detections of one physical line can end up in the same cluster
(reference: View::findCollinearSegments view.cc:212-264, edge emission
line3D.cc:1904-1974).  The counterpart of ``line3dpp_tpu.ops.collinearity``.

:func:`collinear_pairs` and :func:`collinear_similarity` are plain torch,
element-wise over a (B, S, S) grid of a batch of views, in the JAX
functions' expression order, so a pair's decision and its weight are the
same float32 function.  :func:`collinear_edges` gives every view's ``i < j``
edges: on CUDA tensors from the kernel ``csrc/collinearity.cu``
(:func:`collinear_edges_cuda`: the upper triangle of every view's pairs in
tiles, a pre-test, then the same float32 functions, the edges compacted in
row order on the card and read back once), on CPU tensors from
:func:`collinear_edges_plain`, which runs the plain functions over the
views a few at a time and compacts each batch on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from . import kernels

EPS = 1e-12
# rows and columns of a block of the kernel (csrc/collinearity.cu kTile)
TILE = 128
# float32 planes of (B, S, S) alive at once in collinear_similarity, and
# the bytes a batch of views may hold in them
_PLANES = 24
_BATCH_BYTES = 2 << 30


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, which is
    exact for float32 inputs).  The distances below cancel (|w|^2 minus
    its projection's square), so one ulp of a square root shows in the
    similarity; torch's vectorized CPU sqrt is not always correctly
    rounded, XLA's is."""
    return torch.sqrt(x.double()).float()


def _point_line_dist2d(px, py, x1, y1, x2, y2):
    """Distance of (px, py) to the infinite 2D line through the two points."""
    dx = x2 - x1
    dy = y2 - y1
    L = _sqrt(dx * dx + dy * dy)
    return torch.abs(dy * px - dx * py + x2 * y1 - y2 * x1) / \
        torch.clamp_min(L, EPS)


def collinear_pairs(segments: torch.Tensor, mask: torch.Tensor,
                    t_px: float) -> torch.Tensor:
    """(B, S, S) bool: collinear, non-overlapping segment pairs of each of
    B views (segments (B, S, 4), mask (B, S))."""
    S = segments.shape[1]
    x1, y1, x2, y2 = segments.unbind(-1)
    a = lambda t: t[:, :, None]            # noqa: E731  row segment i
    b = lambda t: t[:, None, :]            # noqa: E731  column segment j

    # max mutual point-to-line distance (view.cc:228-244)
    d11 = _point_line_dist2d(a(x1), a(y1), b(x1), b(y1), b(x2), b(y2))
    d12 = _point_line_dist2d(a(x2), a(y2), b(x1), b(y1), b(x2), b(y2))
    d21 = _point_line_dist2d(b(x1), b(y1), a(x1), a(y1), a(x2), a(y2))
    d22 = _point_line_dist2d(b(x2), b(y2), a(x1), a(y1), a(x2), a(y2))
    dmax = torch.maximum(torch.maximum(d11, d12), torch.maximum(d21, d22))

    # only pairs whose intervals along j do NOT overlap are collinear
    # (view.cc:218-226)
    dxj = b(x2 - x1)
    dyj = b(y2 - y1)
    len2 = torch.clamp_min(dxj * dxj + dyj * dyj, EPS)
    t1 = ((a(x1) - b(x1)) * dxj + (a(y1) - b(y1)) * dyj) / len2
    t2 = ((a(x2) - b(x1)) * dxj + (a(y2) - b(y1)) * dyj) / len2
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    overlaps = torch.clamp_min(lo, 0.0) <= torch.clamp_max(hi, 1.0)

    eye = torch.eye(S, dtype=torch.bool, device=segments.device)
    return (dmax < t_px) & ~overlaps & a(mask) & b(mask) & ~eye


def collinear_similarity(est_P1, est_P2, est_d1, est_d2, est_valid, collin,
                         k_reg, median_depth, med_scene_depth: float,
                         min_affinity: float):
    """3D similarity of same-view collinear pairs: (B, S, S) weights and
    validity for B views (est_* (B, S, ...), collin (B, S, S), k_reg and
    median_depth (B,)).

    Position only: the pair is collinear in 2D by construction, and the
    reference's similarity() skips the angle term for such pairs
    (line3D.cc:1460-1465)."""
    dv = [est_P2[..., i] - est_P1[..., i] for i in range(3)]
    lena = _sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
    dira = [c / torch.clamp_min(lena, EPS) for c in dv]

    P1a = [est_P1[..., i][:, :, None] for i in range(3)]
    P2a = [est_P2[..., i][:, :, None] for i in range(3)]
    P1b = [est_P1[..., i][:, None, :] for i in range(3)]
    P2b = [est_P2[..., i][:, None, :] for i in range(3)]
    dir_a = [c[:, :, None] for c in dira]
    dir_b = [c[:, None, :] for c in dira]

    # d^2 = |w|^2 - (w . dir)^2
    def p2l(P, L0, Ld):
        w = [p - l0 for p, l0 in zip(P, L0)]
        w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        proj = w[0] * Ld[0] + w[1] * Ld[1] + w[2] * Ld[2]
        return _sqrt(torch.clamp_min(w2 - proj * proj, 0.0))

    d11 = p2l(P1a, P1b, dir_b)
    d12 = p2l(P2a, P1b, dir_b)
    d21 = p2l(P1b, P1a, dir_a)
    d22 = p2l(P2b, P1a, dir_a)

    cut = (torch.clamp_max(median_depth, med_scene_depth)
           if med_scene_depth > EPS else median_depth)
    sig_a1 = torch.minimum(est_d1, cut[:, None]) * k_reg[:, None]
    sig_a2 = torch.minimum(est_d2, cut[:, None]) * k_reg[:, None]

    def expf(d, sig):
        return torch.exp(-d * d / torch.clamp_min(2.0 * sig * sig, EPS))

    sim_a = torch.minimum(expf(d11, sig_a1[:, :, None]),
                          expf(d12, sig_a2[:, :, None]))
    sim_b = torch.minimum(expf(d21, sig_a1[:, None, :]),
                          expf(d22, sig_a2[:, None, :]))
    sim = torch.minimum(sim_a, sim_b)

    ok = collin & est_valid[:, :, None] & est_valid[:, None, :]
    edge = ok & (sim > min_affinity)
    return torch.where(edge, sim, torch.zeros_like(sim)), edge


def piece_ends(counts: torch.Tensor) -> torch.Tensor:
    """The ends of the kernel's output pieces: the inclusive scan of the
    (V, S, T) edge counts of (view, row, column tile) in row-major order,
    so piece (v, i, c) holds the edges ``[end - count, end)``."""
    return torch.cumsum(counts.reshape(-1), 0).reshape(counts.shape)


@obs.spanned("recon.collinearity")
def collinear_edges(segments, mask, est_P1, est_P2, est_d1, est_d2,
                    est_valid, k_reg, median_depth, med_scene_depth: float,
                    t_px: float, min_affinity: float):
    """The collinearity edges of all views: host arrays ``(view, s1, s2,
    weight)`` with ``s1 < s2``, in row-major order over (view, s1, s2) (the
    order of ``np.nonzero`` on the dense grid); int64 keys, float32
    weights.  Every argument is a tensor on one device but the floats.  On
    CUDA tensors the kernel runs (:func:`collinear_edges_cuda`), on CPU
    tensors the plain functions (:func:`collinear_edges_plain`)."""
    fn = (collinear_edges_cuda if mask.device.type == "cuda"
          else collinear_edges_plain)
    return fn(segments, mask, est_P1, est_P2, est_d1, est_d2, est_valid,
              k_reg, median_depth, med_scene_depth, t_px, min_affinity)


def _check_arguments(segments, mask, est_P1, est_P2, est_d1, est_d2,
                     est_valid, k_reg, median_depth) -> None:
    """Raise unless the arguments are what the kernel takes: contiguous
    tensors on one CUDA device, float32 but the bool masks, of the shapes
    that ``mask`` (V, S) gives, with V <= 65535 (the grid's y)."""
    if mask.dim() != 2:
        raise ValueError(f"mask: shape {tuple(mask.shape)}, expected (V, S)")
    V, S = mask.shape
    if V > 65535:
        raise ValueError(f"{V} views: the kernel takes at most 65535")
    f32, dev = torch.float32, mask.device
    for name, x, dtype, shape in (
            ("segments", segments, f32, (V, S, 4)),
            ("mask", mask, torch.bool, (V, S)),
            ("est_P1", est_P1, f32, (V, S, 3)),
            ("est_P2", est_P2, f32, (V, S, 3)),
            ("est_d1", est_d1, f32, (V, S)),
            ("est_d2", est_d2, f32, (V, S)),
            ("est_valid", est_valid, torch.bool, (V, S)),
            ("k_reg", k_reg, f32, (V,)),
            ("median_depth", median_depth, f32, (V,))):
        kernels.check(name, x, dtype, shape, dev)


def collinear_edges_cuda(segments, mask, est_P1, est_P2, est_d1, est_d2,
                         est_valid, k_reg, median_depth,
                         med_scene_depth: float, t_px: float,
                         min_affinity: float):
    """:func:`collinear_edges` by the kernel ``csrc/collinearity.cu``: a
    count pass over the upper triangle of every view's pairs, the scan of
    its (V, S, T) piece counts (:func:`piece_ends`), one read of the total,
    the write pass and one read of the (E, 4) int32 edges (view, s1, s2,
    the weight's bits).  Counted once a call as ``collinear_edges``."""
    _check_arguments(segments, mask, est_P1, est_P2, est_d1, est_d2,
                     est_valid, k_reg, median_depth)
    V, S = mask.shape
    dev = mask.device
    host = np.zeros((0, 4), np.int32)
    if V and S:
        cut = (torch.clamp_max(median_depth, med_scene_depth)
               if med_scene_depth > EPS else median_depth)
        T = -(-S // TILE)
        counts = torch.empty((V, S, T), dtype=torch.int64, device=dev)
        inputs = [kernels.ptr(x) for x in (
            segments, mask, est_P1, est_P2, est_d1, est_d2, est_valid,
            k_reg, cut)]
        opts = (V, S, T, float(t_px), float(min_affinity))
        kernels.launch("l3d_collinear_count", *inputs, *opts,
                       kernels.ptr(counts), kernels.stream(dev))
        obs.launched("collinear_edges")
        ends = piece_ends(counts)
        total = int(ends.reshape(-1)[-1])
        if total:
            out = torch.empty((total, 4), dtype=torch.int32, device=dev)
            kernels.launch("l3d_collinear_write", *inputs, *opts,
                           kernels.ptr(counts), kernels.ptr(ends),
                           kernels.ptr(out), kernels.stream(dev))
            host = out.cpu().numpy()
    keys = host[:, :3].T.astype(np.int64)
    return keys[0], keys[1], keys[2], host[:, 3].copy().view(np.float32)


def collinear_edges_plain(segments, mask, est_P1, est_P2, est_d1, est_d2,
                          est_valid, k_reg, median_depth,
                          med_scene_depth: float, t_px: float,
                          min_affinity: float):
    """:func:`collinear_edges` by the plain functions, as many views at a
    time as keep the planes within ``_BATCH_BYTES``."""
    V, S = mask.shape
    if not (V and S):
        keys = np.zeros(0, np.int64)
        return keys, keys.copy(), keys.copy(), np.zeros(0, np.float32)
    batch = max(1, _BATCH_BYTES // (_PLANES * 4 * S * S))
    upper = torch.ones((S, S), dtype=torch.bool,
                       device=mask.device).triu_(1)
    parts = []
    for lo in range(0, V, batch):
        sl = slice(lo, min(lo + batch, V))
        collin = collinear_pairs(segments[sl], mask[sl], t_px)
        w, edge = collinear_similarity(
            est_P1[sl], est_P2[sl], est_d1[sl], est_d2[sl], est_valid[sl],
            collin, k_reg[sl], median_depth[sl], med_scene_depth,
            min_affinity)
        idx = torch.nonzero((edge & upper).reshape(-1)).reshape(-1)
        parts.append((idx + lo * S * S, w.reshape(-1)[idx]))
        del collin, w, edge
    idx = torch.cat([p[0] for p in parts]).cpu().numpy()
    w = torch.cat([p[1] for p in parts]).cpu().numpy()
    return idx // (S * S), (idx // S) % S, idx % S, w
