"""A rendered synthetic facade with known 3D lines (numpy only).

The port's copy of the scene of ``tools/validate_scene2.py``: a facade
(z = 10 plane) with eight nested window frames, a roof and a base bar and
one diagonal brace — 74 ground-truth 3D line segments — seen by ``V``
cameras on a slanted track, rendered as filled dark quads on a noisy shaded
background.  The image size and the supersampling factor are arguments:
intrinsics scale with the image, so every size sees the same scene.  At
the tool's size (1024 x 768, ``ss=2``) the images are byte-equal to the
tool's, with the same random draws in the same order.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..camera import Camera, rotation_from_rpy

# the tool's image size, at which the focal length is 900 px
BASE_W, BASE_H = 1024, 768


def build_scene():
    """Returns ``(quads, gt)``: a list of ``(kind, (4, 3) corners)`` with
    kind "dark" or "light" (drawn filled, in order) and the (74, 6)
    ground-truth 3D boundary segments."""
    quads = []
    gt = []

    def rect_quad(cx, cy, hw, hh, z=10.0):
        return np.array([[cx - hw, cy - hh, z], [cx + hw, cy - hh, z],
                         [cx + hw, cy + hh, z], [cx - hw, cy + hh, z]])

    def rect_edges(q):
        return [np.concatenate([q[i], q[(i + 1) % 4]]) for i in range(4)]

    # window frames: a dark ring (outer minus inner); both boundaries are
    # ground-truth lines, 0.08 world units apart (close parallel pairs)
    ring = 0.08
    for gx in range(4):
        for gy in range(2):
            cx = -3.0 + 2.0 * gx
            cy = -1.1 + 2.2 * gy
            outer = rect_quad(cx, cy, 0.55, 0.75)
            inner = rect_quad(cx, cy, 0.55 - ring, 0.75 - ring)
            quads.append(("dark", outer))
            quads.append(("light", inner))
            gt += rect_edges(outer) + rect_edges(inner)

    # long horizontal bars (roof and base)
    roof = rect_quad(0.0, 2.35, 4.2, 0.12)
    base = rect_quad(0.0, -2.35, 4.2, 0.12)
    quads += [("dark", roof), ("dark", base)]
    gt += rect_edges(roof) + rect_edges(base)

    # diagonal brace in the band between the window rows (no crossings)
    th = np.deg2rad(4.0)
    dvec = np.array([np.cos(th), np.sin(th), 0.0])
    perp = np.array([-np.sin(th), np.cos(th), 0.0]) * 0.07
    c0 = np.array([-3.6, -0.22, 10.0])
    brace = np.stack([c0 - perp, c0 + 7.0 * dvec - perp,
                      c0 + 7.0 * dvec + perp, c0 + perp])
    quads.append(("dark", brace))
    gt.append(np.concatenate([brace[0], brace[1]]))
    gt.append(np.concatenate([brace[3], brace[2]]))
    return quads, np.stack(gt)


def make_cameras(V: int = 10, seed: int = 11, width: int = BASE_W,
                 height: int = BASE_H) -> list[Camera]:
    """``V`` cameras on a slanted track spanning the facade (the track does
    not depend on ``V``); focal length 900 px at 1024 x 768, scaled with
    the image size, principal point at the image centre."""
    rng = np.random.default_rng(seed)
    K = np.array([[900.0 * width / BASE_W, 0, width / 2],
                  [0, 900.0 * height / BASE_H, height / 2],
                  [0, 0, 1]])
    cams = []
    for i in range(V):
        t = 9.0 * i / max(V - 1, 1)
        C = np.array([-2.7 + 0.55 * t, -0.9 + 0.22 * t + rng.normal() * 0.1,
                      rng.normal() * 0.25])
        yaw = -0.05 * (t - 5.0) + rng.normal() * 0.01
        pitch = 0.02 * (t - 5.0) + rng.normal() * 0.01
        R = rotation_from_rpy(pitch, yaw, rng.normal() * 0.01)
        cams.append(Camera(K, R, -R @ C, width, height))
    return cams


def render(cam: Camera, quads, seed: int, ss: int = 2) -> np.ndarray:
    """Rasterise the filled quads with ``ss`` x ``ss`` supersampling onto a
    noisy, shaded background; returns a (height, width) uint8 image."""
    rng = np.random.default_rng(seed)
    W, H = cam.width, cam.height
    ws, hs = W * ss, H * ss
    Ks = cam.K.copy()
    Ks[:2] *= ss
    scam = Camera(Ks, cam.R, cam.t, ws, hs)

    xx, yy = np.meshgrid(np.arange(ws) + 0.5, np.arange(hs) + 0.5)
    # smooth illumination gradient + texture noise
    img = (205.0 - 18.0 * (xx / ws) - 10.0 * (yy / hs)
           + rng.normal(scale=3.5, size=(hs, ws)))

    for kind, q in quads:
        pts = scam.project(q)                            # (4, 2)
        # the inside test runs on the quad's bounding box widened by one
        # pixel (no pixel beyond it is inside a convex quad); the random
        # draws and their order are those of a full-image test
        x0, y0 = np.maximum(np.floor(pts.min(0)).astype(int) - 1, 0)
        x1, y1 = np.ceil(pts.max(0)).astype(int) + 1
        box = (slice(y0, min(y1, hs)), slice(x0, min(x1, ws)))
        bx, by = xx[box], yy[box]
        inside = np.ones(bx.shape, bool)
        for i in range(4):
            a, b = pts[i], pts[(i + 1) % 4]
            cross = ((b[0] - a[0]) * (by - a[1])
                     - (b[1] - a[1]) * (bx - a[0]))
            inside &= cross > 0
        if kind == "dark":
            img[box][inside] = 52.0 + rng.normal(scale=2.5,
                                                 size=int(inside.sum()))
        else:
            noise = rng.normal(scale=3.5, size=(hs, ws))[box]
            img[box][inside] = (205.0 - 18.0 * (bx / ws) - 10.0 * (by / hs)
                                + noise)[inside]

    img = img.reshape(H, ss, W, ss).mean(axis=(1, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def image_digest(img: np.ndarray) -> str:
    """SHA-256 of an image's shape and bytes (hex)."""
    h = hashlib.sha256(repr((img.shape, str(img.dtype))).encode())
    h.update(np.ascontiguousarray(img).tobytes())
    return h.hexdigest()
