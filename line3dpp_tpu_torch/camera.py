"""Camera model and pose math (a copy of ``line3dpp_tpu.camera``; the
quaternion and projection-matrix helpers of the SfM readers come with
ROADMAP item 11).

Host-side camera bookkeeping runs in float64 numpy (matching the reference's
Eigen doubles, reference: view.cc:22-42); the batched device-side struct is
float32, which is sufficient once the scene is median-centered (reference:
line3D.cc:500-536 performs the same centering for numerical stability).

World convention: ``x_cam = R @ X + t``, camera center ``C = -R.T @ t``,
viewing ray of pixel p (homogeneous): ``ray = normalize(R.T @ K^-1 @ p)``
(reference: view.cc:25-28, 317-321).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Camera:
    """A single pinhole camera (host side, float64)."""

    K: np.ndarray          # (3,3) intrinsics
    R: np.ndarray          # (3,3) world->cam rotation
    t: np.ndarray          # (3,)  world->cam translation
    width: int
    height: int
    median_depth: float = 1.0   # median scene depth (from SfM worldpoints)

    def __post_init__(self):
        self.K = np.asarray(self.K, dtype=np.float64).reshape(3, 3)
        self.R = np.asarray(self.R, dtype=np.float64).reshape(3, 3)
        self.t = np.asarray(self.t, dtype=np.float64).reshape(3)

    @property
    def Kinv(self) -> np.ndarray:
        return np.linalg.inv(self.K)

    @property
    def C(self) -> np.ndarray:
        return -self.R.T @ self.t

    @property
    def RtKinv(self) -> np.ndarray:
        return self.R.T @ self.Kinv

    @property
    def pp(self) -> np.ndarray:
        """Principal point (homogeneous)."""
        return np.array([self.K[0, 2], self.K[1, 2], 1.0])

    @property
    def diagonal(self) -> float:
        return float(np.hypot(self.width, self.height))

    def ray(self, p: np.ndarray) -> np.ndarray:
        """Normalized viewing ray through pixel p=(x,y) (reference: view.cc:317-327)."""
        ph = np.array([p[0], p[1], 1.0])
        r = self.RtKinv @ ph
        return r / np.linalg.norm(r)

    def optical_axis(self) -> np.ndarray:
        return self.ray(self.pp[:2])

    def spatial_regularizer(self, sigma_px: float) -> float:
        """k = sin(angle subtended by sigma_px pixels at the principal point)
        (reference: view.cc:301-314)."""
        r0 = self.ray(self.pp[:2])
        r1 = self.ray(self.pp[:2] + np.array([sigma_px, 0.0]))
        alpha = np.arccos(np.clip(r0 @ r1, -1.0, 1.0))
        return float(np.sin(alpha))

    def project(self, X: np.ndarray) -> np.ndarray:
        """Project world point(s) (..., 3) to pixels (..., 2) (reference: view.cc:374-392)."""
        X = np.asarray(X, dtype=np.float64)
        q = X @ self.R.T + self.t
        q = q / q[..., 2:3]
        uv = q @ self.K.T
        return uv[..., :2] / uv[..., 2:3]


# ---------------------------------------------------------------------------
# pose helpers (reference: line3D.cc:2714-2852)
# ---------------------------------------------------------------------------

def rotation_from_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Rotation matrix from roll/pitch/yaw, Rz*Ry*Rx composition order as in
    Eigen AngleAxis products (reference: line3D.cc:2714-2727)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def fundamental_matrix(cam1: Camera, cam2: Camera) -> np.ndarray:
    """F mapping points in image 1 to epipolar lines in image 2:
    F = K2^-T [t]x R K1^-1 with R = R2 R1^T, t = t2 - R t1
    (reference: line3D.cc:861-897)."""
    R = cam2.R @ cam1.R.T
    t = cam2.t - R @ cam1.t
    Tx = np.array(
        [
            [0.0, -t[2], t[1]],
            [t[2], 0.0, -t[0]],
            [-t[1], t[0], 0.0],
        ]
    )
    E = Tx @ R
    return np.linalg.inv(cam2.K.T) @ E @ np.linalg.inv(cam1.K)


def fundamental_matrices(cameras: Sequence[Camera], src_idx: np.ndarray,
                         tgt_idx: np.ndarray) -> np.ndarray:
    """Batched :func:`fundamental_matrix` over (src, tgt) index pairs.

    One vectorized einsum pass replaces the per-pair Python loop (the
    reference computes F per pair on demand, line3D.cc:861-897); at
    thousands of views the host loop dominated phase-2 setup.
    Returns (P, 3, 3) float64.
    """
    src_idx = np.asarray(src_idx, np.int64).reshape(-1)
    tgt_idx = np.asarray(tgt_idx, np.int64).reshape(-1)
    R = np.stack([c.R for c in cameras])                   # (V, 3, 3)
    t = np.stack([c.t for c in cameras])                   # (V, 3)
    Kinv = np.linalg.inv(np.stack([c.K for c in cameras]))  # (V, 3, 3)

    R_rel = np.einsum("pij,pkj->pik", R[tgt_idx], R[src_idx])
    t_rel = t[tgt_idx] - np.einsum("pij,pj->pi", R_rel, t[src_idx])

    P = len(src_idx)
    Tx = np.zeros((P, 3, 3))
    Tx[:, 0, 1] = -t_rel[:, 2]
    Tx[:, 0, 2] = t_rel[:, 1]
    Tx[:, 1, 0] = t_rel[:, 2]
    Tx[:, 1, 2] = -t_rel[:, 0]
    Tx[:, 2, 0] = -t_rel[:, 1]
    Tx[:, 2, 1] = t_rel[:, 0]

    E = Tx @ R_rel
    return np.einsum("pji,pjk,pkl->pil", Kinv[tgt_idx], E, Kinv[src_idx])


def median_center_translation(cameras: Sequence[Camera]) -> np.ndarray:
    """Median of camera-center coordinates, used to re-center the scene for
    float stability (reference: line3D.cc:500-536).

    The reference takes, per axis, the median over *non-zero* coordinates
    using the upper-median index n//2.
    """
    centers = np.stack([c.C for c in cameras], axis=0)
    trans = np.zeros(3)
    for i in range(3):
        vals = centers[:, i]
        vals = vals[np.abs(vals) > 1e-12]
        if vals.size:
            trans[i] = np.sort(vals)[vals.size // 2]
    return trans


@dataclasses.dataclass
class CameraBatch:
    """Batched float32 camera arrays for device-side kernels.

    All arrays are stacked over the view axis V in a fixed order; the pipeline
    owns the mapping between view index and the user-visible camera ID.
    """

    K: np.ndarray        # (V,3,3) f32
    R: np.ndarray        # (V,3,3) f32
    t: np.ndarray        # (V,3)   f32
    C: np.ndarray        # (V,3)   f32
    RtKinv: np.ndarray   # (V,3,3) f32
    k_reg: np.ndarray    # (V,)    f32 spatial regularizer per view
    median_depth: np.ndarray  # (V,) f32
    width: np.ndarray    # (V,) f32
    height: np.ndarray   # (V,) f32

    @staticmethod
    def from_cameras(
        cameras: Sequence[Camera],
        sigma_p: float,
        translation: np.ndarray | None = None,
        med_scene_depth: float | None = None,
        fixed_3d_regularizer: bool = False,
    ) -> "CameraBatch":
        """Stack cameras, apply median-centering, compute per-view regularizer k
        (reference: line3D.cc:438-454)."""
        if translation is None:
            translation = median_center_translation(cameras)
        Ks, Rs, ts, Cs, RtKinvs, ks = [], [], [], [], [], []
        for cam in cameras:
            C = cam.C - translation        # reference: view.cc:510-514
            t = -cam.R @ C
            Ks.append(cam.K)
            Rs.append(cam.R)
            ts.append(t)
            Cs.append(C)
            RtKinvs.append(cam.RtKinv)
            if fixed_3d_regularizer:
                # metric sigma: k = sigma_p / med_scene_depth (view.h:123-127)
                ks.append(abs(sigma_p) / max(med_scene_depth or 1.0, 1e-12))
            else:
                ks.append(cam.spatial_regularizer(max(sigma_p, 0.1)))
        f32 = np.float32
        return CameraBatch(
            K=np.stack(Ks).astype(f32),
            R=np.stack(Rs).astype(f32),
            t=np.stack(ts).astype(f32),
            C=np.stack(Cs).astype(f32),
            RtKinv=np.stack(RtKinvs).astype(f32),
            k_reg=np.array(ks, dtype=f32),
            median_depth=np.array([c.median_depth for c in cameras], dtype=f32),
            width=np.array([c.width for c in cameras], dtype=f32),
            height=np.array([c.height for c in cameras], dtype=f32),
        )
