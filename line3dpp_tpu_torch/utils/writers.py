"""Result writers: STL / OBJ / TXT / BIN.

Formats match the reference byte-for-byte in structure (reference:
line3D.cc:2465-2711), and the bytes equal those of ``line3dpp_tpu``'s writers
on the same lines.  ``.bin`` is either the reference's boost binary archive
(``ref_bin.save_bin_boost``) or a numpy ``.npz`` (:func:`save_bin`, which
also keeps the residuals' 2D endpoints); :func:`load_bin` reads both.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FinalLine3D:
    """One reconstructed 3D line: collinear 3D sub-segments + 2D residuals.

    Mirrors the reference's FinalLine3D (reference: segment3D.h:164-177).
    """

    segments3d: np.ndarray   # (n, 6)  [P|Q] world coords
    residuals: np.ndarray    # (m, 6)  [camID segID p1x p1y q1x q1y]


def save_txt(path: str, lines: list[FinalLine3D]) -> None:
    """`n P Q ... m camID segID p q ...` per row (line3D.cc:2631-2687)."""
    with open(path, "w") as f:
        for line in lines:
            if len(line.segments3d) == 0:
                continue
            parts = [str(len(line.segments3d))]
            for seg in line.segments3d:
                parts += [_fmt(v) for v in seg]
            parts.append(str(len(line.residuals)))
            for r in line.residuals:
                parts += [str(int(r[0])), str(int(r[1]))]
                parts += [_fmt(v) for v in r[2:]]
            f.write(" ".join(parts) + " \n")


def save_stl(path: str, lines: list[FinalLine3D]) -> None:
    """Degenerate triangle (v1,v2,v1) per 3D segment (line3D.cc:2465-2527)."""
    with open(path, "w") as f:
        f.write("solid lineModel\n")
        for line in lines:
            for seg in line.segments3d:
                p, q = seg[:3], seg[3:]
                f.write(" facet normal 1.0e+000 0.0e+000 0.0e+000\n")
                f.write("  outer loop\n")
                f.write(f"   vertex {p[0]:e} {p[1]:e} {p[2]:e}\n")
                f.write(f"   vertex {q[0]:e} {q[1]:e} {q[2]:e}\n")
                f.write(f"   vertex {p[0]:e} {p[1]:e} {p[2]:e}\n")
                f.write("  endloop\n")
                f.write(" endfacet\n")
        f.write("endsolid lineModel\n")


def save_obj(path: str, lines: list[FinalLine3D]) -> None:
    """v-pairs followed by l records (line3D.cc:2579-2628)."""
    with open(path, "w") as f:
        n_pts = 0
        for line in lines:
            for seg in line.segments3d:
                p, q = seg[:3], seg[3:]
                f.write(f"v {_fmt(p[0])} {_fmt(p[1])} {_fmt(p[2])}\n")
                f.write(f"v {_fmt(q[0])} {_fmt(q[1])} {_fmt(q[2])}\n")
                n_pts += 2
        for i in range(1, n_pts, 2):
            f.write(f"l {i} {i + 1}\n")


def save_bin(path: str, lines: list[FinalLine3D]) -> None:
    """The result as a compressed numpy archive, under ``path`` as given."""
    seg_counts = np.array([len(l.segments3d) for l in lines], dtype=np.int64)
    res_counts = np.array([len(l.residuals) for l in lines], dtype=np.int64)
    segs = (np.concatenate([l.segments3d for l in lines], axis=0)
            if lines else np.zeros((0, 6)))
    ress = (np.concatenate([l.residuals for l in lines], axis=0)
            if lines else np.zeros((0, 6)))
    # through a file handle, so that numpy does not append ".npz"
    with open(path, "wb") as f:
        np.savez_compressed(f, seg_counts=seg_counts, res_counts=res_counts,
                            segments=segs, residuals=ress)


def load_bin(path: str) -> list[FinalLine3D]:
    """A ``.bin`` result in either format: a boost binary archive (the
    reference's, and ``Line3D.save_bin``'s default) or the npz variant."""
    with open(path, "rb") as f:
        head = f.read(30)
    if b"serialization::archive" in head:
        from .ref_bin import load_reference_bin
        return load_reference_bin(path)
    with np.load(path) as data:
        segs, ress = data["segments"], data["residuals"]
        seg_counts, res_counts = data["seg_counts"], data["res_counts"]
    so = np.concatenate([[0], np.cumsum(seg_counts)])
    ro = np.concatenate([[0], np.cumsum(res_counts)])
    return [FinalLine3D(segments3d=segs[so[i]:so[i + 1]],
                        residuals=ress[ro[i]:ro[i + 1]])
            for i in range(len(seg_counts))]


def _fmt(v: float) -> str:
    """Shortest round-trip C++ ostream-like float formatting (6 sig digits)."""
    return f"{v:.6g}"
