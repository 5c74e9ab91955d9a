"""Batched 3D/2D geometry primitives (PyTorch, float32).

Vectorized equivalents of the reference's per-entity Eigen math (reference:
view.cc:317-371 rays/unprojection, segment3D.h:68-73 point-to-line
distance, line3D.cc:1571-1583 undirected segment angle).  Every function
works on arbitrary leading batch dimensions.

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


def normalize(v: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """v / max(|v|, EPS) along ``axis``; an axis of length 3 takes the
    fixed-order :func:`dot3`."""
    w = torch.movedim(v, axis, -1)
    n = (torch.sqrt(dot3(w, w)) if w.shape[-1] == 3
         else torch.linalg.vector_norm(w, dim=-1))
    return torch.movedim(w / torch.clamp_min(n, EPS)[..., None], -1, axis)


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


def unproject(C: torch.Tensor, ray: torch.Tensor,
              depth: torch.Tensor) -> torch.Tensor:
    """3D point at given depth along a normalized ray (view.cc:356-371)."""
    return C + ray * depth[..., None]


def seg3d_dir(P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    return normalize(P2 - P1)


def seg3d_length(P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    d = P2 - P1
    return torch.sqrt(dot3(d, d))


def angle_deg_undirected(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Undirected angle between unit directions, in degrees
    (reference: line3D.cc:1571-1583)."""
    ang = torch.acos(torch.clamp(dot3(d1, d2), -1.0, 1.0)) * DEG
    return torch.where(ang > 90.0, 180.0 - ang, ang)


def point_to_line_dist(P: torch.Tensor, L1: torch.Tensor,
                       Ldir: torch.Tensor) -> torch.Tensor:
    """Distance of point(s) P to the infinite line through L1 with unit
    direction Ldir (reference: segment3D.h:68-73)."""
    w = P - L1
    r = w - dot3(w, Ldir)[..., None] * Ldir
    return torch.sqrt(dot3(r, r))


def line_through(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Homogeneous 2D line through two homogeneous points."""
    return cross(p, q)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for (..., 3, 3) and (..., 3), each row a :func:`dot3`."""
    return (A[..., :, 0] * x[..., 0, None] + A[..., :, 1] * x[..., 1, None]
            + A[..., :, 2] * x[..., 2, None])


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    """x where |x| > EPS, else EPS (a safe divisor)."""
    return torch.where(torch.abs(x) > EPS, x, torch.full_like(x, EPS))


def project_points(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   X: torch.Tensor) -> torch.Tensor:
    """Project world points (..., 3) into pixels (..., 2) (view.cc:374-392)."""
    q = _matvec(R, X) + t
    uv = _matvec(K, q / _nonzero(q[..., 2:3]))
    return uv[..., :2] / _nonzero(uv[..., 2:3])


def closest_point_params_line_to_ray(
        P: torch.Tensor, u: torch.Tensor, Q: torch.Tensor,
        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Parameter s along line (P, u) of the closest point to the ray
    (Q, v), and a validity mask.  Mirrors project2DsegmentOnto3Dline
    (reference: line3D.cc:2221-2266).

    Returns (s, valid) with closest point = P + s*u.
    """
    w = P - Q
    a, b, c = dot3(u, u), dot3(u, v), dot3(v, v)
    d, e = dot3(u, w), dot3(v, w)
    denom = a * c - b * b
    valid = torch.abs(denom) > EPS
    s = (b * e - c * d) / torch.where(valid, denom, torch.ones_like(denom))
    return s, valid
