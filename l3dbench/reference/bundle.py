"""Line bundling in float64 torch, written from Line3D++'s optimization
(optimization.cc:8-303, optimization.h:40-170): cameras held constant,
each cluster's 3D line refined alone by Levenberg-Marquardt over its
four-parameter orthonormal form (Zhang & Koch 2014: a rotation U in
Cayley parameters s, and w with (|m|, |v|) = (cos w, sin w) for the
Pluecker line (m, v) = (cos w U e1, sin w U e2)).

An observation is a member's 2D segment: its residuals are the distances
of the two endpoints to the projected line, times exp(2 angle) of the
segment against that line, under Huber's loss with delta 2 as
iteratively reweighted least squares.  The Jacobians come from automatic
differentiation (``torch.func.jacfwd``).  The damping follows the
program's documented schedule (start 1e-3, x0.33 on an accepted step, x3
on a rejected one, within [1e-9, 1e6], on the diagonal of J^T J), so that
both stop at the same iterate where the line has converged.
"""

from __future__ import annotations

import torch

EPS = 1e-12
HUBER = 2.0


def skew(s: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(s[..., 0])
    return torch.stack([
        torch.stack([z, -s[..., 2], s[..., 1]], -1),
        torch.stack([s[..., 2], z, -s[..., 0]], -1),
        torch.stack([-s[..., 1], s[..., 0], z], -1)], -2)


def cayley(s: torch.Tensor) -> torch.Tensor:
    """U = (I + [s]x)(I - [s]x)^-1
    = ((1 - s.s) I + 2 s s^T + 2 [s]x) / (1 + s.s)."""
    ss = (s * s).sum(-1)[..., None, None]
    I = torch.eye(3, dtype=s.dtype, device=s.device)
    return ((1.0 - ss) * I + 2.0 * s[..., :, None] * s[..., None, :]
            + 2.0 * skew(s)) / (1.0 + ss)


def cayley_inverse(U: torch.Tensor) -> torch.Tensor:
    """s with cayley(s) = U: [s]x = (U + I)^-1 (U - I)."""
    I = torch.eye(3, dtype=U.dtype, device=U.device).expand(U.shape)
    X = torch.linalg.solve(U + I, U - I)
    return torch.stack([X[..., 2, 1], X[..., 0, 2], X[..., 1, 0]], -1)


def params_of_line(P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """(s1, s2, s3, w) of the lines through P1 and P2, (C, 3) each."""
    v = P2 - P1
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(EPS)
    m = torch.linalg.cross(P1, v, dim=-1)
    nm = torch.linalg.vector_norm(m, dim=-1)
    # a line through the origin: any unit vector normal to v
    e = torch.zeros_like(v)
    e[:, 0] = 1.0
    alt = torch.linalg.cross(v, e, dim=-1)
    e2 = torch.zeros_like(v)
    e2[:, 1] = 1.0
    small = torch.linalg.vector_norm(alt, dim=-1, keepdim=True) <= 1e-6
    alt = torch.where(small, torch.linalg.cross(v, e2, dim=-1), alt)
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    mh = torch.where((nm > 1e-9)[:, None], m / nm.clamp_min(EPS)[:, None],
                     alt)
    U = torch.stack([mh, v, torch.linalg.cross(mh, v, dim=-1)], -1)
    return torch.cat([cayley_inverse(U),
                      torch.atan2(torch.ones_like(nm), nm)[:, None]], 1)


def pluecker(p: torch.Tensor):
    U = cayley(p[..., :3])
    return (torch.cos(p[..., 3:4]) * U[..., :, 0],
            torch.sin(p[..., 3:4]) * U[..., :, 1])


def residual(p, KinvT, R, t, q1, q2, sdir):
    """The two weighted endpoint distances of one observation."""
    m, v = pluecker(p)
    n = R @ m + torch.linalg.cross(t, R @ v, dim=-1)
    l = KinvT @ n
    nrm = torch.sqrt(l[0] * l[0] + l[1] * l[1]).clamp_min(EPS)
    sin = torch.abs(-l[1] * sdir[1] - l[0] * sdir[0]) / nrm
    w = torch.exp(2.0 * torch.asin(sin.clamp(0.0, 1.0 - 1e-6)))
    return torch.stack([(l @ q1) / nrm * w, (l @ q2) / nrm * w])


def huber_sqrt_weight(r: torch.Tensor) -> torch.Tensor:
    a = r.abs()
    return torch.sqrt(torch.where(a <= HUBER, torch.ones_like(a),
                                  HUBER / a.clamp_min(EPS)))


def optimize(P1, P2, cluster, obs, iterations: int):
    """Bundled lines: the points of P1 and P2 (C, 3) moved onto each
    refined line, and its unit direction.  ``cluster`` (O,) names each
    observation's line, ``obs`` = (K^-T, R, t, q1, q2, sdir) per
    observation (homogeneous endpoints, unit 2D direction)."""
    C = P1.shape[0]
    res = torch.func.vmap(residual)
    jac = torch.func.vmap(torch.func.jacfwd(residual))

    def sums(x):
        out = torch.zeros((C,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return out.index_add_(0, cluster, x)

    def cost(p):
        r = res(p[cluster], *obs)
        return sums(((huber_sqrt_weight(r) * r) ** 2).sum(-1))

    p = params_of_line(P1, P2)
    lam = torch.full((C,), 1e-3, dtype=p.dtype, device=p.device)
    eye = torch.eye(4, dtype=p.dtype, device=p.device)
    c_old = cost(p)
    for _ in range(iterations):
        pc = p[cluster]
        r = res(pc, *obs)                                  # (O, 2)
        J = jac(pc, *obs)                                  # (O, 2, 4)
        h = huber_sqrt_weight(r)
        Jw, rw = h[..., None] * J, h * r
        JTJ = sums(Jw.transpose(1, 2) @ Jw)
        g = sums((Jw.transpose(1, 2) @ rw[..., None])[..., 0])
        diag = torch.diagonal(JTJ, dim1=-2, dim2=-1).clamp_min(1e-8)
        step = torch.linalg.solve(JTJ + lam[:, None, None] * diag[:, :, None]
                                  * eye, g[..., None])[..., 0]
        trial = p - step
        c_new = cost(trial)
        better = c_new < c_old
        p = torch.where(better[:, None], trial, p)
        c_old = torch.where(better, c_new, c_old)
        lam = torch.where(better, lam * 0.33, lam * 3.0).clamp(1e-9, 1e6)

    m, v = pluecker(p)
    u = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(EPS)
    P0 = torch.linalg.cross(v, m, dim=-1) / (v * v).sum(-1, keepdim=True
                                                        ).clamp_min(EPS)
    Q1 = P0 + ((P1 - P0) * u).sum(-1, keepdim=True) * u
    Q2 = P0 + ((P2 - P0) * u).sum(-1, keepdim=True) * u
    ok = (torch.isfinite(Q1).all(1) & torch.isfinite(Q2).all(1)
          & (torch.linalg.vector_norm(Q2 - Q1, dim=-1) > EPS))
    Q1 = torch.where(ok[:, None], Q1, P1)
    Q2 = torch.where(ok[:, None], Q2, P2)
    d = Q2 - Q1
    return Q1, Q2, d / torch.linalg.vector_norm(d, dim=-1,
                                                keepdim=True).clamp_min(EPS)
