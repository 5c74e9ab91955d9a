"""Batched 3D-line bundle adjustment (PyTorch port of
``line3dpp_tpu.ops.bundling``).

The reference bundles clustered 3D lines with a Ceres solver over a Cayley
line parametrization, holding cameras and intrinsics constant (reference:
optimization.cc:8-303, optimization.h:40-170; parametrization from Zhang &
Koch 2014).  Because the cameras are constant, every line's 4 parameters
are independent: the problem is block-diagonal, a batched
Levenberg-Marquardt over (C, 4).  Per-observation Jacobians are the
forward tangents along the 4 axes, written out by hand, the
normal equations are per-cluster sums, and each iteration solves one 4 x 4
system per cluster.

Line representation: Plücker (m, v) with the orthonormal/Cayley
parametrization (s1, s2, s3, w):

    U = cayley(s)  in SO(3),   columns [m_hat, v_hat, m_hat x v_hat]
    (|m|, |v|) = (cos w, sin w)

Projection of the line into a camera (x = K(RX + t)):

    n_cam = R m + [t]x R v          (plane normal through centre and line)
    l_img = K^-T n_cam              (2D image line coefficients)

Residual per observed 2D segment: the two endpoint-to-line distances,
amplified by exp(2 * angle(observed direction, projected line direction))
(reference: optimization.h:52-167), with Huber(2.0) IRLS weights
(optimization.h:50, optimization.cc:139).

Per-cluster sums are deterministic: the observations are sorted by cluster
once and each cluster's run is reduced in order (``torch.segment_reduce``),
so no floating-point atomics take part and the accept/reject decisions of
two runs on the same device agree.  All arrays have their exact sizes; the
JAX package's power-of-two padding is a recompilation workaround and is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from .geometry import cross as cross3

EPS = 1e-12
HUBER_DELTA = 2.0


# ---------------------------------------------------------------------------
# Cayley <-> Plücker
# ---------------------------------------------------------------------------

def cayley_to_rotation(s: torch.Tensor) -> torch.Tensor:
    """U = (I - [s]x)(I + [s]x)^-1 in closed form, batched over leading
    dims."""
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    n = 1.0 + s1 * s1 + s2 * s2 + s3 * s3
    U = torch.stack([
        torch.stack([1 + s1 * s1 - s2 * s2 - s3 * s3,
                     2 * (s1 * s2 - s3), 2 * (s1 * s3 + s2)], -1),
        torch.stack([2 * (s1 * s2 + s3),
                     1 - s1 * s1 + s2 * s2 - s3 * s3, 2 * (s2 * s3 - s1)], -1),
        torch.stack([2 * (s1 * s3 - s2), 2 * (s2 * s3 + s1),
                     1 - s1 * s1 - s2 * s2 + s3 * s3], -1),
    ], -2)
    return U / n[..., None, None]


def rotation_to_cayley(U: torch.Tensor) -> torch.Tensor:
    """Inverse Cayley: s = vee((U - I)(U + I)^-1); batched."""
    I = torch.eye(3, dtype=U.dtype, device=U.device)
    A = torch.linalg.solve((U + I).transpose(-1, -2),
                           (U - I).transpose(-1, -2)).transpose(-1, -2)
    return torch.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]], -1)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def plucker_from_endpoints(P1: torch.Tensor, P2: torch.Tensor):
    """Plücker (m, v) of the line through P1, P2 (v unit, m = P x v)."""
    v = P2 - P1
    v = v / _norm(v, True).clamp_min(EPS)
    return cross3(P1, v), v


def params_from_plucker(m: torch.Tensor, v: torch.Tensor):
    """(s, w) orthonormal parameters of Plücker (m, v)."""
    nm = _norm(m)
    nv = _norm(v)
    m_hat = m / nm.clamp_min(EPS)[..., None]
    # a line through the origin (m ~ 0): pick any normal to v
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device)
    alt = cross3(v, ex.expand_as(v))
    alt = torch.where(_norm(alt, True) > 1e-6, alt,
                      cross3(v, ey.expand_as(v)))
    alt = alt / _norm(alt, True).clamp_min(EPS)
    m_hat = torch.where((nm > 1e-9)[..., None], m_hat, alt)
    v_hat = v / nv.clamp_min(EPS)[..., None]
    U = torch.stack([m_hat, v_hat, cross3(m_hat, v_hat)], dim=-1)  # columns
    return rotation_to_cayley(U), torch.atan2(nv, nm)


def plucker_from_params(s: torch.Tensor, w: torch.Tensor):
    U = cayley_to_rotation(s)
    return (torch.cos(w)[..., None] * U[..., :, 0],
            torch.sin(w)[..., None] * U[..., :, 1])


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def _mv3(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for a 3 x 3 matrix, as written-out float32 sums (no matrix
    unit, so no reduced-precision product on any device)."""
    return (A[..., 0] * x[..., None, 0] + A[..., 1] * x[..., None, 1]
            + A[..., 2] * x[..., None, 2])


def _obs_residual(params, KinvT, R, t, p1h, p2h, seg_dir):
    """Two endpoint-to-projected-line distances of one observation.

    params: (4,) = (s1, s2, s3, w); KinvT = K^-T (3, 3); p*h homogeneous
    endpoint pixels; seg_dir: unit 2D direction of the observed segment
    (reference: optimization.h:66-158).  Also batched over leading dims."""
    m, v = plucker_from_params(params[..., :3], params[..., 3])
    n_cam = _mv3(R, m) + cross3(t, _mv3(R, v))
    l_img = _mv3(KinvT, n_cam)
    norm = torch.sqrt(l_img[..., 0] ** 2 + l_img[..., 1] ** 2)
    inv = 1.0 / norm.clamp_min(EPS)
    d1 = (l_img * p1h).sum(-1) * inv
    d2 = (l_img * p2h).sum(-1) * inv
    # the angle comes from the cross product (arcsin form): arccos(|dot|)
    # has a singular derivative at alignment, the optimum, which stalls LM
    ldx = -l_img[..., 1] * inv
    ldy = l_img[..., 0] * inv
    sinang = (ldx * seg_dir[..., 1] - ldy * seg_dir[..., 0]).abs()
    ang = torch.asin(sinang.clamp(0.0, 1.0 - 1e-6))
    wgt = torch.exp(2.0 * ang)
    return torch.stack([d1 * wgt, d2 * wgt], dim=-1)


def _frame_tangents(params):
    """Plücker (m, v) of the parameters with their forward tangents:
    two (5, O, 3) stacks, row 0 the value, rows 1-4 its derivatives along
    s1, s2, s3 and w (the quotient rule on U = N / n written out)."""
    s1, s2, s3, w = params.unbind(-1)
    zero, two = torch.zeros_like(s1), torch.full_like(s1, 2.0)
    n = 1.0 + s1 * s1 + s2 * s2 + s3 * s3
    # numerators of U's first two columns and their derivatives by s1..s3
    N0 = torch.stack([1 + s1 * s1 - s2 * s2 - s3 * s3, 2 * (s1 * s2 + s3),
                      2 * (s1 * s3 - s2)], -1)
    N1 = torch.stack([2 * (s1 * s2 - s3), 1 - s1 * s1 + s2 * s2 - s3 * s3,
                      2 * (s2 * s3 + s1)], -1)
    dN0 = torch.stack([
        torch.stack([2 * s1, 2 * s2, 2 * s3], -1),
        torch.stack([-2 * s2, 2 * s1, -two], -1),
        torch.stack([-2 * s3, two, 2 * s1], -1)])
    dN1 = torch.stack([
        torch.stack([2 * s2, -2 * s1, two], -1),
        torch.stack([2 * s1, 2 * s2, 2 * s3], -1),
        torch.stack([-two, -2 * s3, 2 * s2], -1)])
    dn = torch.stack([2 * s1, 2 * s2, 2 * s3])[..., None]      # (3, O, 1)
    inv_n = (1.0 / n)[..., None]
    u0, u1 = N0 * inv_n, N1 * inv_n
    du0 = (dN0 - u0 * dn) * inv_n                              # (3, O, 3)
    du1 = (dN1 - u1 * dn) * inv_n
    cw, sw = torch.cos(w)[..., None], torch.sin(w)[..., None]
    m = torch.cat([(cw * u0)[None], cw * du0, (-sw * u0)[None]])
    v = torch.cat([(sw * u1)[None], sw * du1, (cw * u1)[None]])
    return m, v


def _res_and_jac(params, KinvT, R, t, p1h, p2h, seg_dir):
    """Residuals (O, 2) of :func:`_obs_residual` and their Jacobians
    (O, 2, 4) by the parameters: the forward tangents along the 4 axes,
    written out (the projection is linear in (m, v), so values and tangents
    pass through it as one (5, O, 3) stack)."""
    m, v = _frame_tangents(params)
    l = _mv3(KinvT, _mv3(R, m) + cross3(t.expand_as(m), _mv3(R, v)))
    l0, l1 = l[0, :, 0], l[0, :, 1]
    dl0, dl1 = l[1:, :, 0], l[1:, :, 1]                         # (4, O)
    norm = torch.sqrt(l0 ** 2 + l1 ** 2)
    inv = 1.0 / norm.clamp_min(EPS)
    dinv = torch.where(norm > EPS, -(l0 * dl0 + l1 * dl1) * inv ** 3, 0.0)
    cross_ = (-l1 * seg_dir[:, 1] - l0 * seg_dir[:, 0]) * inv
    dcross = ((-dl1 * seg_dir[:, 1] - dl0 * seg_dir[:, 0]) * inv
              + (-l1 * seg_dir[:, 1] - l0 * seg_dir[:, 0]) * dinv)
    sinang = cross_.abs()
    top = 1.0 - 1e-6
    x = sinang.clamp(0.0, top)
    dx = torch.where(sinang <= top, torch.sign(cross_) * dcross, 0.0)
    wgt = torch.exp(2.0 * torch.asin(x))
    dwgt = 2.0 * wgt * dx / torch.sqrt(1.0 - x * x)
    res, jac = [], []
    for ph in (p1h, p2h):
        dot = (l[0] * ph).sum(-1)
        d = dot * inv
        dd = (l[1:] * ph).sum(-1) * inv + dot * dinv
        res.append(d * wgt)
        jac.append(dd * wgt + d * dwgt)
    return torch.stack(res, -1), torch.stack(jac, 0).permute(2, 0, 1)


def _huber_w(r: torch.Tensor) -> torch.Tensor:
    """IRLS sqrt-weights of the Huber loss (delta 2.0, optimization.cc:139)."""
    a = r.abs()
    return torch.sqrt(torch.where(a <= HUBER_DELTA, 1.0,
                                  HUBER_DELTA / a.clamp_min(EPS)))


class _Problem:
    """The observations sorted by cluster, and the per-cluster sums."""

    def __init__(self, obs_cluster, obs, num_clusters: int):
        oc = obs_cluster.long()
        if oc.numel() and (int(oc.min()) < 0 or int(oc.max()) >= num_clusters):
            raise ValueError("obs_cluster outside [0, num_clusters)")
        order = torch.argsort(oc, stable=True)
        self.cluster = oc[order]
        self.obs = tuple(a[order] for a in obs)
        self.lengths = torch.bincount(self.cluster, minlength=num_clusters)
        self.C = num_clusters

    def cluster_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """(O, ...) -> (C, ...): each cluster's run summed in order."""
        flat = vals.reshape(vals.shape[0], -1)
        out = torch.segment_reduce(flat, "sum", lengths=self.lengths,
                                   unsafe=True)
        return out.reshape((self.C,) + vals.shape[1:])

    def cost(self, r: torch.Tensor) -> torch.Tensor:
        return self.cluster_sum(((_huber_w(r) * r) ** 2).sum(-1))

    def residuals(self, params: torch.Tensor) -> torch.Tensor:
        return _obs_residual(params[self.cluster], *self.obs)


def lm_optimize(params0, obs_cluster, KinvT, R, t, p1h, p2h, seg_dir,
                num_clusters: int, iterations: int = 25) -> torch.Tensor:
    """Batched Levenberg-Marquardt over independent 4-parameter lines.

    params0 (C, 4) initial (s1, s2, s3, w); obs_cluster (O,) the cluster of
    each observation; per observation KinvT (O, 3, 3), R (O, 3, 3), t (O, 3),
    p1h, p2h (O, 3) homogeneous endpoints and seg_dir (O, 2).  Damping
    starts at 1e-3, x 0.33 after an accepted step and x 3 after a rejected
    one, within [1e-9, 1e6]."""
    C = num_clusters
    prob = _Problem(obs_cluster, (KinvT, R, t, p1h, p2h, seg_dir), C)
    params = params0.clone()
    lam = torch.full((C,), 1e-3, dtype=params.dtype, device=params.device)
    eye = torch.eye(4, dtype=params.dtype, device=params.device)
    # the cost at the current parameters; an accepted step hands its own on
    c_old = prob.cost(prob.residuals(params))
    for _ in range(iterations):
        with obs.span("recon.bundle.lm_iteration"):
            r, J = _res_and_jac(params[prob.cluster], *prob.obs)
            hw = _huber_w(r)                                  # (O, 2)
            rw = hw * r
            Jw = hw[..., None] * J                            # (O, 2, 4)
            JTJ = prob.cluster_sum(Jw[:, 0, :, None] * Jw[:, 0, None, :]
                                   + Jw[:, 1, :, None] * Jw[:, 1, None, :])
            g = prob.cluster_sum(Jw[:, 0] * rw[:, 0, None]
                                 + Jw[:, 1] * rw[:, 1, None])
            diag = torch.diagonal(JTJ, dim1=-2, dim2=-1)
            A = JTJ + (lam[:, None] * diag.clamp_min(1e-8))[:, :, None] * eye
            delta = torch.linalg.solve(A, g[..., None])[..., 0]
            new_params = params - delta
            c_new = prob.cost(prob.residuals(new_params))
            better = c_new < c_old
            params = torch.where(better[:, None], new_params, params)
            c_old = torch.where(better, c_new, c_old)
            lam = torch.where(better, lam * 0.33, lam * 3.0).clamp(1e-9, 1e6)
    return params


def lm_cost(params, obs_cluster, KinvT, R, t, p1h, p2h, seg_dir,
            num_clusters: int) -> torch.Tensor:
    """Per-cluster robustified cost at ``params``."""
    prob = _Problem(obs_cluster, (KinvT, R, t, p1h, p2h, seg_dir),
                    num_clusters)
    return prob.cost(prob.residuals(params))


# ---------------------------------------------------------------------------
# the pipeline's entry point
# ---------------------------------------------------------------------------

LM_ARRAYS = ("params0", "obs_cluster", "Ko", "Ro", "to", "p1h", "p2h", "d2")


def problem_from_capture(capture: dict, device) -> dict:
    """The LM inputs the JAX package captured
    (``optimize_cluster_lines(_capture=...)``) as tensors on ``device``,
    without its padding: ``C`` clusters and the observations of clusters
    below ``C``.  Returns the ``LM_ARRAYS`` and ``C``."""
    C = int(capture["C"])
    real = np.asarray(capture["obs_cluster"]) < C
    out = {"C": C, "params0": torch.tensor(
        np.asarray(capture["params0"])[:C], device=device)}
    for name in LM_ARRAYS[1:]:
        out[name] = torch.tensor(np.asarray(capture[name])[real],
                                 device=device)
    return out


@obs.spanned("recon.bundle")
def optimize_cluster_lines(lineP1, lineP2, mc, mv, ms, C, st, config,
                           iterations: int | None = None,
                           device: str | torch.device | None = None,
                           _capture: dict | None = None):
    """Refine the cluster lines by minimising the 2D endpoint-to-projected-
    line reprojection error, cameras constant (reference:
    optimization.cc:8-303).

    ``lineP1``, ``lineP2`` (C, 3) are the fitted lines in the centred frame,
    ``mc``, ``mv``, ``ms`` each member's cluster, view and segment, ``st`` the
    pipeline state with the camera batch ``cb`` and the (V, S, 4) ``segs``.
    Returns numpy (P1, P2, unit_dir) of shape (C, 3).  ``iterations``
    defaults to ``config.max_iter_optim`` (the reference's Ceres cap,
    commons.h:88); ``_capture`` receives the assembled LM inputs.  The
    optimisation runs on ``device``: a CUDA device by default, the CPU only
    when asked with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "line bundling runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    cb = st["cb"]
    p = st["segs"][mv, ms]                              # (O, 4)
    Ko = np.transpose(np.linalg.inv(cb.K[mv]), (0, 2, 1)).astype(np.float32)
    ones = np.ones((len(p), 1), np.float32)
    d2 = p[:, 2:4] - p[:, 0:2]
    d2 = d2 / np.maximum(np.linalg.norm(d2, axis=1, keepdims=True), EPS)
    to_dev = lambda a, dt=np.float32: torch.from_numpy(
        np.ascontiguousarray(a, dtype=dt)).to(device)

    m0, v0 = plucker_from_endpoints(to_dev(lineP1), to_dev(lineP2))
    s0, w0 = params_from_plucker(m0, v0)
    inputs = dict(
        params0=torch.cat([s0, w0[:, None]], dim=1),
        obs_cluster=to_dev(mc, np.int64), Ko=to_dev(Ko),
        Ro=to_dev(cb.R[mv]), to=to_dev(cb.t[mv]),
        p1h=to_dev(np.concatenate([p[:, 0:2], ones], 1)),
        p2h=to_dev(np.concatenate([p[:, 2:4], ones], 1)), d2=to_dev(d2))
    if iterations is None:
        iterations = int(config.max_iter_optim)
    if _capture is not None:
        _capture.update({k: v.cpu().numpy() for k, v in inputs.items()}, C=C)
    params = lm_optimize(*(inputs[k] for k in LM_ARRAYS), num_clusters=C,
                         iterations=int(iterations))

    m, v = plucker_from_params(params[:, :3], params[:, 3])
    m = m.cpu().numpy().astype(np.float64)
    v = v.cpu().numpy().astype(np.float64)
    vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), EPS)
    # closest point of the new line to the origin: P0 = v x m / |v|^2
    P0 = np.cross(v, m) / np.maximum(np.sum(v * v, axis=1, keepdims=True),
                                     EPS)
    # endpoint recovery: project the old endpoints onto the refined line
    # (reference: optimization.cc:208-295)
    t1 = np.sum((lineP1 - P0) * vn, axis=1, keepdims=True)
    t2 = np.sum((lineP2 - P0) * vn, axis=1, keepdims=True)
    newP1 = P0 + t1 * vn
    newP2 = P0 + t2 * vn

    # clusters whose refinement diverged keep the fitted line
    ok = (np.isfinite(newP1).all(1) & np.isfinite(newP2).all(1)
          & (np.linalg.norm(newP2 - newP1, axis=1) > EPS))
    newP1 = np.where(ok[:, None], newP1, lineP1)
    newP2 = np.where(ok[:, None], newP2, lineP2)
    dirs = newP2 - newP1
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), EPS)
    return newP1, newP2, dirs
