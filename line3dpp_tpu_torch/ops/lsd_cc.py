"""Connected components of the LSD detector's aligned-pixel graph.

Two pixels are linked when they are 8-neighbours, both active, and their
level-line angles differ by at most the round's tolerance (reference: the
greedy region grow of lsd.cpp:1704-1754, reformulated as connected
components).  As in the JAX package (``line3dpp_tpu/ops/lsd_cc.py``) the
components are found in two levels:

1. :func:`cc_tiles` labels each tile of the padded grid on its own: the
   label of a pixel is the padded-grid flat index of the smallest pixel of
   its component within the tile, ``INVALID`` for inactive pixels.  CUDA
   tensors go through kernel K4 (``csrc/lsd_cc.cu``, a union-find in
   shared memory per patch of a tile, :func:`cc_patch`), CPU
   tensors through :func:`cc_tiles_plain` (min-label propagation with
   pointer jumping).  The labels depend on the tile-local graph alone, so
   both give the same labels bit for bit.
2. :func:`merge_tile_labels` (plain torch) joins components across tile
   borders: the aligned links between the border rows and columns form a
   small graph, resolved by the same fixed 8 iterations of hooking and
   pointer jumping as the JAX package, into a map ``T`` from tile labels to
   merged labels.  The links are compacted exactly, so there is no link cap.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import obs
from . import kernels

INVALID = 2**30
BIG_ANGLE = 100.0
# float32 values of 2 pi and pi, as the JAX package's weak-typed constants
# become inside its float32 expressions
TWO_PI = float(np.float32(2.0 * math.pi))
PI = float(np.float32(math.pi))

# kernel K4's patch: at most PATCH_H rows of PATCH_W pixels (cc_patch)
PATCH_H, PATCH_W = 32, 128

NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0),
             (1, 1), (1, -1), (-1, 1), (-1, -1))


def angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| wrapped to [0, pi] (lsd.cpp ``angle_diff``), in float32."""
    d = (a - b).abs()
    d = torch.where(d > TWO_PI, d - TWO_PI, d)
    return torch.where(d > PI, TWO_PI - d, d)


def shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[y, x] = x[y + dy, x + dx]``, ``fill`` where that lies outside."""
    H, W = x.shape
    out = torch.full_like(x, fill)
    y0, y1 = max(0, -dy), H - max(0, dy)
    x0, x1 = max(0, -dx), W - max(0, dx)
    if y1 > y0 and x1 > x0:
        out[y0:y1, x0:x1] = x[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _check_grid(angle, active, tile) -> None:
    hp, wp = angle.shape
    th, tw = tile
    if hp % th or wp % tw:
        raise ValueError(f"grid {hp}x{wp} is not a multiple of the tile "
                         f"{th}x{tw}")
    if tuple(active.shape) != (hp, wp):
        raise ValueError(f"active {tuple(active.shape)} != angle {(hp, wp)}")
    if hp * wp >= INVALID:
        raise ValueError(f"grid {hp}x{wp} has too many pixels for int32 "
                         f"labels below INVALID = 2**30")


def cc_tiles_plain(angle: torch.Tensor, active: torch.Tensor, tol: float,
                   tile: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile-local min-label propagation with two pointer jumps per sweep,
    run until no label changes."""
    _check_grid(angle, active, tile)
    hp, wp = angle.shape
    th, tw = tile
    dev = angle.device
    tol = float(np.float32(tol))
    yy = torch.arange(hp, device=dev)[:, None]
    xx = torch.arange(wp, device=dev)[None, :]
    links = []
    for dy, dx in NEIGHBORS:
        n_ang = shift(angle, dy, dx, BIG_ANGLE)
        n_act = shift(active, dy, dx, False)
        same_tile = (torch.div(yy + dy, th, rounding_mode="floor")
                     == yy // th) & (torch.div(xx + dx, tw,
                                               rounding_mode="floor")
                                     == xx // tw)
        links.append(active & n_act & same_tile
                     & (angle_diff(angle, n_ang) <= tol))

    flat_idx = torch.arange(hp * wp, dtype=torch.int32, device=dev)
    lab = torch.where(active, flat_idx.reshape(hp, wp), INVALID)
    while True:
        best = lab
        for (dy, dx), linked in zip(NEIGHBORS, links):
            best = torch.minimum(best, torch.where(
                linked, shift(lab, dy, dx, INVALID), INVALID))
        flat = best.reshape(-1)
        for _ in range(2):
            safe = torch.where(flat == INVALID, 0, flat).long()
            flat = torch.where(flat == INVALID, INVALID, flat[safe])
        new = flat.reshape(hp, wp)
        if torch.equal(new, lab):
            break
        lab = new
    return lab, torch.zeros((1, 1), dtype=torch.int32, device=dev)


def cc_patch(tile: tuple) -> tuple[int, int]:
    """The (ph, pw) patch that one block of kernel K4 labels in shared
    memory: ``(min(th, 32), 128)``.  It divides every tile that
    ``ops/lsd.py:_tile_for`` returns (heights 8-256 in powers of two,
    widths 128-1024), so a patch lies inside one tile."""
    th, tw = tile
    ph, pw = min(th, PATCH_H), PATCH_W
    if th % ph or tw % pw:
        raise ValueError(f"tile {th}x{tw} is not a multiple of kernel K4's "
                         f"patch {ph}x{pw}")
    return ph, pw


def cc_tiles_cuda(angle: torch.Tensor, active: torch.Tensor, tol: float,
                  tile: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4 on CUDA tensors: float32 ``angle`` and bool ``active`` of
    one padded (hp, wp) grid, starting on 16 bytes (the kernel's loads)."""
    _check_grid(angle, active, tile)
    hp, wp = angle.shape
    dev = angle.device
    kernels.check("angle", angle, torch.float32, (hp, wp), dev)
    kernels.check("active", active, torch.bool, (hp, wp), dev)
    ph, pw = cc_patch(tile)
    if angle.data_ptr() % 16 or active.data_ptr() % 16:
        raise ValueError("angle, active: kernel K4 reads them with 16-byte "
                         "loads")
    labels = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    unconverged = torch.empty((1, 1), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_cc_tiles", p(angle), p(active), hp, wp, tile[0],
                   tile[1], ph, pw, ctypes.c_float(float(np.float32(tol))),
                   p(labels), p(unconverged), kernels.stream(dev))
    obs.launched("cc_tiles")
    return labels, unconverged


def cc_tiles(angle: torch.Tensor, active: torch.Tensor, tol: float,
             tile: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile-local connected components of a padded grid.  Returns the
    (hp, wp) int32 labels and a (1, 1) count of tiles that did not converge,
    which is always 0 here (both versions run to convergence) and is kept
    for the JAX package's interface."""
    if angle.is_cuda:
        return cc_tiles_cuda(angle.contiguous(), active.contiguous(), tol,
                             tile)
    return cc_tiles_plain(angle, active, tol, tile)


def _border_links(lab, angle, active, tol: float, stride: int, axis: int):
    """Label pairs (a, b) of the aligned links across the tile borders of
    one axis: row ``stride - 1`` (mod stride) against the next row, at
    column offsets -1, 0 and +1 (so diagonal links across a corner are
    covered).  INVALID where there is no link."""
    if axis == 1:
        lab, angle, active = lab.T, angle.T, active.T
    hp, wp = lab.shape
    n = hp // stride - 1
    if n <= 0:
        empty = torch.zeros((0,), dtype=lab.dtype, device=lab.device)
        return empty, empty

    def top(x):          # last row of tiles 0..n-1
        return x.reshape(-1, stride, wp)[:n, stride - 1]

    def bot(x):          # first row of tiles 1..n
        return x.reshape(-1, stride, wp)[1:, 0]

    top_l, top_a, top_m = top(lab), top(angle), top(active)
    bot_l, bot_a, bot_m = bot(lab), bot(angle), bot(active)
    cols = torch.arange(wp, device=lab.device)[None, :]
    outs_a, outs_b = [], []
    for dx in (-1, 0, 1):
        bl = torch.roll(bot_l, -dx, dims=1)
        ba = torch.roll(bot_a, -dx, dims=1)
        bm = torch.roll(bot_m, -dx, dims=1)
        if dx:
            bm = bm & (cols != (wp - 1 if dx == 1 else 0))
        linked = top_m & bm & (angle_diff(top_a, ba) <= tol)
        outs_a.append(torch.where(linked, top_l, INVALID).reshape(-1))
        outs_b.append(torch.where(linked, bl, INVALID).reshape(-1))
    return torch.cat(outs_a), torch.cat(outs_b)


def merge_tile_labels(lab: torch.Tensor, angle: torch.Tensor,
                      active: torch.Tensor, tol: float, tile: tuple,
                      iters: int = 8) -> tuple[torch.Tensor, int]:
    """Join tile components across tile borders.

    Returns ``(T, n_links)``: ``T`` is the (hp * wp,) int32 map from a tile
    label to its merged label (the identity off the linked labels), to be
    applied as ``T[label]`` for valid labels, and ``n_links`` the number of
    aligned border links.  Like the JAX package, the union-find runs a fixed
    ``iters`` iterations of hooking and two pointer jumps, so the merged
    labels are the JAX package's even where that has not converged."""
    hp, wp = lab.shape
    tol = float(np.float32(tol))
    ha, hb = _border_links(lab, angle, active, tol, tile[0], 0)
    va, vb = _border_links(lab, angle, active, tol, tile[1], 1)
    la = torch.cat([ha, va])
    lb = torch.cat([hb, vb])
    valid = (la != INVALID) & (lb != INVALID)
    la, lb = la[valid], lb[valid]
    T = torch.arange(hp * wp, dtype=torch.int32, device=lab.device)
    n_links = la.numel()
    if n_links == 0:
        return T, 0
    nodes, inv = torch.unique(torch.cat([la, lb]), return_inverse=True)
    ia, ib = inv[:n_links], inv[n_links:]
    parent = torch.arange(nodes.numel(), device=lab.device)
    for _ in range(iters):
        pa = parent[ia]
        pb = parent[ib]
        lo = torch.minimum(pa, pb)
        parent = parent.scatter_reduce(0, pa, lo, "amin")
        parent = parent.scatter_reduce(0, pb, lo, "amin")
        parent = parent[parent]
        parent = parent[parent]
    T[nodes.long()] = nodes[parent]
    return T, n_links
