"""Batched 3D/2D geometry primitives (PyTorch, float32).

Vectorized equivalents of the reference's per-entity Eigen math (reference:
view.cc:317-371 rays/unprojection).  Every function works on arbitrary
leading batch dimensions.

The 3-term dot products are written out as elementwise products and sums in
a fixed order, ``(a0*b0 + a1*b1) + a2*b2``.  The CUDA kernels evaluate the
same expressions with ``__fmul_rn``/``__fadd_rn`` (no FMA contraction), so a
kernel and its plain version agree bit for bit where they share inputs.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12
DEG = 180.0 / math.pi     # radians -> degrees


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over a trailing axis of 3: ``(a0*b0 + a1*b1) + a2*b2``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, EPS) over the trailing axis of 3."""
    n = torch.sqrt(dot3(v, v))
    return v / torch.clamp_min(n, EPS)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def rays_from_pixels(RtKinv: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Normalized viewing rays ``RtKinv @ (x, y, 1)`` for pixels.

    RtKinv: (..., 3, 3), xy: (..., 2) -> (..., 3)  (reference: view.cc:317-327)
    """
    x = xy[..., 0, None]
    y = xy[..., 1, None]
    ray = RtKinv[..., :, 0] * x + RtKinv[..., :, 1] * y + RtKinv[..., :, 2]
    return normalize(ray)


def segment_rays(RtKinv: torch.Tensor,
                 segments: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rays through both endpoints of 2D segments (..., 4) -> two (..., 3)."""
    return (rays_from_pixels(RtKinv, segments[..., 0:2]),
            rays_from_pixels(RtKinv, segments[..., 2:4]))
