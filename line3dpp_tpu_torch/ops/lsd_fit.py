"""The LSD rectangle-fit passes over the label-sorted pixel list.

After connected components the active pixels are sorted by component label
(``ops/lsd.py``).  Every pixel carries a component slot in ``[0, C]``: the
slots of real components (runs of >= 5 pixels) increase along the list and
each component is one contiguous run; ``C`` is the dump slot of every other
pixel, and dump pixels lie between the runs.  Per-component tables are
``(C, 8)`` float32 rows ``(cos t, sin t, cx, cy, gate, center, 0, 0)``.

The four passes (JAX package: ``line3dpp_tpu/ops/lsd_fit.py``):

* :func:`moments` (K7): per component Σw, Σwx, Σwy, Σwx², Σwy², Σwxy and
  the pixel count, with w = mag · pix, as a (C, 8) table (column 7 zero);
* :func:`gate_pixels` (K9): keep a pixel when it lies in its component's
  band ``|w_proj - center| <= gate`` and its level-line angle is aligned
  with the component axis (``|cos(ang) ct + sin(ang) st| >= cos_tol``);
  dump pixels are kept when ``dump_keep`` and ``pix != 0``;
* :func:`gate_moments` (K8): K9, then K7 on the gated pixels, in one pass;
* :func:`extents` (K11): per component, over the pixels with ``pix != 0``,
  min l_proj, min w_proj, min -l_proj, min -w_proj as a (C, 4) table,
  ``BIG`` for a component without such pixels.

Each wrapper launches its CUDA kernel (``csrc/lsd_fit.cu``) for CUDA tensors
and runs its plain torch version for CPU tensors.  The moment sums are
accumulated in float64 by both versions (the product terms are float32, as
in the JAX package), so the two differ only in the last bit of the float32
result; the extents and the gate are exact.  ``band_counts`` (K10, the
rescue cascade) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

BIG = 1e9
TABLE_COLS = 8


def _rows(slot: torch.Tensor, tables: torch.Tensor, C: int):
    """Each pixel's table row (zeros for dump pixels) and the mask of
    pixels in a real component."""
    valid = slot < C
    if C == 0:
        return torch.zeros((slot.numel(), TABLE_COLS), dtype=torch.float32,
                           device=slot.device), valid
    return tables[slot.clamp(max=C - 1).long()], valid


def _moment_terms(xs, ys, mag, pix) -> torch.Tensor:
    """The 7 float32 terms per pixel, in the JAX package's product order."""
    w = mag * pix
    return torch.stack([w, w * xs, w * ys, w * xs * xs, w * ys * ys,
                        w * xs * ys, pix], dim=1)


def moments_plain(slot, xs, ys, mag, pix, C: int) -> torch.Tensor:
    """Per-component sums in float64 over the float32 terms."""
    acc = torch.zeros((C + 1, 7), dtype=torch.float64, device=slot.device)
    acc.index_add_(0, slot.long(), _moment_terms(xs, ys, mag, pix).double())
    out = torch.zeros((C, TABLE_COLS), dtype=torch.float32,
                      device=slot.device)
    out[:, :7] = acc[:C]
    return out


def gate_pixels_plain(slot, xs, ys, ang, pix, tables, dump_keep: bool,
                      cos_tol: float, C: int) -> torch.Tensor:
    row, valid = _rows(slot, tables, C)
    ct, st, cx, cy, gate, center = row[:, :6].unbind(1)
    dxp = xs - cx
    dyp = ys - cy
    w_proj = (-dxp * st + dyp * ct) - center
    aligned = (torch.cos(ang) * ct + torch.sin(ang) * st).abs() >= cos_tol
    keep = (pix != 0.0) & (w_proj.abs() <= gate) & aligned
    dump = (pix != 0.0) if dump_keep else torch.zeros_like(keep)
    return torch.where(valid, keep, dump).to(torch.float32)


def extents_plain(slot, xs, ys, pix, tables, C: int) -> torch.Tensor:
    row, valid = _rows(slot, tables, C)
    ct, st, cx, cy = row[:, :4].unbind(1)
    dxp = xs - cx
    dyp = ys - cy
    l_proj = dxp * ct + dyp * st
    w_proj = -dxp * st + dyp * ct
    vals = torch.stack([l_proj, w_proj, -l_proj, -w_proj], dim=1)
    inpix = ((pix != 0.0) & valid)[:, None]
    vals = torch.where(inpix, vals, BIG)
    out = torch.full((C + 1, 4), BIG, dtype=torch.float32, device=slot.device)
    out.scatter_reduce_(0, slot.long()[:, None].expand(-1, 4), vals, "amin")
    return out[:C]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_pixels(C: int, tables=None, **planes) -> tuple[int, torch.device]:
    slot = planes["slot"]
    n, dev = slot.numel(), slot.device
    kernels.check("slot", slot, torch.int32, (n,), dev)
    for name, t in planes.items():
        if name != "slot":
            kernels.check(name, t, torch.float32, (n,), dev)
    if tables is not None:
        kernels.check("tables", tables, torch.float32, (C, TABLE_COLS), dev)
    if n >= 2**31:
        raise ValueError(f"{n} pixels do not fit the kernels' int32 indices")
    return n, dev


def moments_cuda(slot, xs, ys, mag, pix, C: int) -> torch.Tensor:
    """Kernel K7."""
    n, dev = _check_pixels(C, slot=slot, xs=xs, ys=ys, mag=mag, pix=pix)
    out = torch.empty((C, TABLE_COLS), dtype=torch.float32, device=dev)
    scratch = torch.empty((C, 7), dtype=torch.float64, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_moments", p(slot), p(xs), p(ys), p(mag), p(pix), n,
                   C, p(scratch), p(out), kernels.stream(dev))
    kernels.LAUNCHES["moments"] += 1
    return out


def gate_moments_cuda(slot, xs, ys, ang, mag, pix, tables, dump_keep: bool,
                      cos_tol: float, C: int):
    """Kernel K8."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, ang=ang,
                           mag=mag, pix=pix)
    newpix = torch.empty((n,), dtype=torch.float32, device=dev)
    out = torch.empty((C, TABLE_COLS), dtype=torch.float32, device=dev)
    scratch = torch.empty((C, 7), dtype=torch.float64, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_gate_moments", p(slot), p(xs), p(ys), p(ang), p(mag),
                   p(pix), p(tables), n, C, int(bool(dump_keep)),
                   ctypes.c_float(cos_tol), p(newpix), p(scratch), p(out),
                   kernels.stream(dev))
    kernels.LAUNCHES["gate_moments"] += 1
    return newpix, out


def gate_pixels_cuda(slot, xs, ys, ang, pix, tables, dump_keep: bool,
                     cos_tol: float, C: int) -> torch.Tensor:
    """Kernel K9."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, ang=ang,
                           pix=pix)
    newpix = torch.empty((n,), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_gate_pixels", p(slot), p(xs), p(ys), p(ang), p(pix),
                   p(tables), n, C, int(bool(dump_keep)),
                   ctypes.c_float(cos_tol), p(newpix), kernels.stream(dev))
    kernels.LAUNCHES["gate_pixels"] += 1
    return newpix


def extents_cuda(slot, xs, ys, pix, tables, C: int) -> torch.Tensor:
    """Kernel K11."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, pix=pix)
    out = torch.empty((C, 4), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_extents", p(slot), p(xs), p(ys), p(pix), p(tables),
                   n, C, p(out), kernels.stream(dev))
    kernels.LAUNCHES["extents"] += 1
    return out


# ---------------------------------------------------------------------------
# the entry points: kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------

def moments(slot, xs, ys, mag, pix, C: int) -> torch.Tensor:
    if slot.is_cuda:
        return moments_cuda(slot, xs, ys, mag, pix, C)
    return moments_plain(slot, xs, ys, mag, pix, C)


def gate_pixels(slot, xs, ys, ang, pix, tables, dump_keep: bool,
                cos_tol: float, C: int) -> torch.Tensor:
    if slot.is_cuda:
        return gate_pixels_cuda(slot, xs, ys, ang, pix, tables, dump_keep,
                                cos_tol, C)
    return gate_pixels_plain(slot, xs, ys, ang, pix, tables, dump_keep,
                             cos_tol, C)


def gate_moments(slot, xs, ys, ang, mag, pix, tables, dump_keep: bool,
                 cos_tol: float, C: int):
    """``(newpix, moments)``: :func:`gate_pixels`, then :func:`moments` of
    the gated pixels."""
    if slot.is_cuda:
        return gate_moments_cuda(slot, xs, ys, ang, mag, pix, tables,
                                 dump_keep, cos_tol, C)
    newpix = gate_pixels_plain(slot, xs, ys, ang, pix, tables, dump_keep,
                               cos_tol, C)
    return newpix, moments_plain(slot, xs, ys, mag, newpix, C)


def extents(slot, xs, ys, pix, tables, C: int) -> torch.Tensor:
    if slot.is_cuda:
        return extents_cuda(slot, xs, ys, pix, tables, C)
    return extents_plain(slot, xs, ys, pix, tables, C)


def band_counts(*args, **kwargs):
    """Kernel K10 of the rescue cascade: not ported yet."""
    raise NotImplementedError(
        "band_counts (kernel K10, the LSD rescue cascade) is not ported to "
        "line3dpp_tpu_torch yet (ROADMAP item 13)")
