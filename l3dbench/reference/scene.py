"""The scene as the reference sets it up from a cell's inputs, in float64:
each view's segments after Line3D++'s length filter, the cameras in the
frame centred on the median camera centre, each view's spatial
regulariser, the visual neighbours and the fundamental matrices.

Camera convention: ``x_cam = R X + t``, centre ``C = -R^T t``, the ray
of pixel ``p`` is ``R^T K^-1 (p, 1)`` normalised (Line3D++ view.cc:22-42,
317-327).
"""

from __future__ import annotations

import numpy as np


def tf32(x: np.ndarray) -> np.ndarray:
    """Float values rounded to TF32 (10 mantissa bits, to nearest even),
    kept in float64."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32).astype(np.float64).reshape(
        np.shape(x))


def keep_segments(segs: np.ndarray, diagonal: float, o: dict) -> np.ndarray:
    """Segments at least ``min_line_length_factor`` of the diagonal long,
    the ``max_line_segments`` longest of them in their input order
    (line3D.cc:320-360)."""
    segs = np.asarray(segs, np.float64).reshape(-1, 4)
    length = np.sqrt((segs[:, 2] - segs[:, 0]) ** 2
                     + (segs[:, 3] - segs[:, 1]) ** 2)
    long_enough = np.flatnonzero(length >= diagonal
                                 * o["min_line_length_factor"])
    if len(long_enough) > o["max_line_segments"]:
        rank = np.argsort(-length[long_enough], kind="stable")
        long_enough = np.sort(long_enough[rank[:o["max_line_segments"]]])
    return segs[long_enough]


def upper_median(values: np.ndarray) -> float:
    v = np.sort(np.asarray(values, np.float64))
    return float(v[len(v) // 2])


def neighbours(centres: np.ndarray, o: dict) -> list[list[int]]:
    """The ``N0`` nearest camera centres of each view (ties to the lower
    index), then the back edges of ``match_symmetrization``: under
    ``"ordered"`` view j gains i when i lists j, j does not list i and
    i < j, as Line3D++ propagates inverse matches only to views processed
    later (line3D.cc:1672-1699)."""
    V = len(centres)
    lists = []
    for i in range(V):
        d = np.sqrt(((centres - centres[i]) ** 2).sum(1))
        d[i] = np.inf
        order = np.argsort(d, kind="stable")[:o["N0"]]
        lists.append([int(j) for j in order if np.isfinite(d[j])])
    sym = o["match_symmetrization"]
    if sym != "none":
        for i in range(V):
            for j in lists[i]:
                if i not in lists[j] and (sym == "full" or i < j):
                    lists[j].append(i)
    return lists


class Scene:
    """Everything the reference's step reads, float64 numpy: ``segs``
    (V, S, 4), ``mask`` (V, S), ``RtKinv`` (V, 3, 3), ``C`` (V, 3) centred,
    ``k_reg`` (V,), ``nbr`` (V, N) and ``pair_valid`` (V, N), ``F``
    (V, N, 3, 3) from view v to its neighbour; and, for the
    reconstruction, ``K``, ``R``, ``t`` (uncentred), ``translation``,
    ``diagonal`` (V,), ``cam_ids``.  With ``precision="tf32"`` the
    float arrays are rounded to TF32 (the control)."""

    TF32_FLOATS = ("segs", "RtKinv", "C", "k_reg", "F", "K", "R", "t")

    def __init__(self, inputs: dict, o: dict, precision: str = "fp32"):
        views = sorted(inputs["views"], key=lambda v: v[0])
        V, S = len(views), o["S"]
        self.cam_ids = [int(v[0]) for v in views]
        self.K = np.stack([np.asarray(v[1], np.float64).reshape(3, 3)
                           for v in views])
        self.R = np.stack([np.asarray(v[2], np.float64).reshape(3, 3)
                           for v in views])
        self.t = np.stack([np.asarray(v[3], np.float64).reshape(3)
                           for v in views])
        self.diagonal = np.array([np.hypot(v[4], v[5]) for v in views])
        self.segs = np.zeros((V, S, 4))
        self.mask = np.zeros((V, S), bool)
        for i, v in enumerate(views):
            kept = keep_segments(v[6], self.diagonal[i], o)[:S]
            self.segs[i, :len(kept)] = kept
            self.mask[i, :len(kept)] = True

        centres = -np.einsum("vji,vj->vi", self.R, self.t)
        self.translation = np.zeros(3)
        for a in range(3):
            nz = centres[:, a][np.abs(centres[:, a]) > 1e-12]
            if len(nz):
                self.translation[a] = upper_median(nz)
        self.C = centres - self.translation
        Kinv = np.linalg.inv(self.K)
        self.RtKinv = np.einsum("vji,vjk->vik", self.R, Kinv)

        # sin of the angle that sigma_p pixels subtend at the principal
        # point (view.cc:301-314)
        self.k_reg = np.zeros(V)
        sig = max(o["sigma_p"], 0.1)
        for i in range(V):
            cx, cy = self.K[i, 0, 2], self.K[i, 1, 2]
            r0 = self.RtKinv[i] @ np.array([cx, cy, 1.0])
            r1 = self.RtKinv[i] @ np.array([cx + sig, cy, 1.0])
            cos = r0 @ r1 / (np.linalg.norm(r0) * np.linalg.norm(r1))
            self.k_reg[i] = np.sin(np.arccos(np.clip(cos, -1.0, 1.0)))

        lists = neighbours(centres, o)
        N = max(o["N0"], max(len(x) for x in lists))
        self.nbr = np.zeros((V, N), np.int64)
        self.pair_valid = np.zeros((V, N), bool)
        for i, lst in enumerate(lists):
            self.nbr[i, :len(lst)] = lst
            self.pair_valid[i, :len(lst)] = True

        # F maps pixels of view v to epipolar lines of its neighbour u:
        # K_u^-T [t_vu]x R_vu K_v^-1 (line3D.cc:861-897)
        tc = -np.einsum("vij,vj->vi", self.R, self.C)
        self.F = np.zeros((V, N, 3, 3))
        for v in range(V):
            for g in np.flatnonzero(self.pair_valid[v]):
                u = self.nbr[v, g]
                R_vu = self.R[u] @ self.R[v].T
                t_vu = tc[u] - R_vu @ tc[v]
                tx = np.array([[0.0, -t_vu[2], t_vu[1]],
                               [t_vu[2], 0.0, -t_vu[0]],
                               [-t_vu[1], t_vu[0], 0.0]])
                self.F[v, g] = Kinv[u].T @ tx @ R_vu @ Kinv[v]
        if precision == "tf32":
            for name in self.TF32_FLOATS:
                setattr(self, name, tf32(getattr(self, name)))
        elif precision != "fp32":
            raise ValueError(precision)

    @property
    def V(self) -> int:
        return self.mask.shape[0]
