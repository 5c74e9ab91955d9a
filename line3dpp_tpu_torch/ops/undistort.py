"""Image undistortion (reference: Line3D::undistortImage line3D.cc:83-109).

The reference delegates to OpenCV's ``initUndistortRectifyMap`` + ``remap``
with 3 radial + 2 tangential coefficients.  As in ``line3dpp_tpu``, the same
Brown model builds the undistorted-to-distorted coordinate map and samples
the source image bilinearly, clamped at the border; here in float32 torch on
the card.  The JAX package computes it outside any Pallas kernel, so it has
no kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch


def _undistort_core(img: torch.Tensor, K: torch.Tensor,
                    dist: torch.Tensor) -> torch.Tensor:
    """``img`` (H, W) float32, ``K`` (3, 3), ``dist`` (k1, k2, k3, p1, p2),
    in the JAX package's order of operations."""
    H, W = img.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, k3, p1, p2 = dist.unbind(0)
    u = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    x = ((u - cx) / fx).expand(H, W)
    y = ((v - cy) / fy).expand(H, W)

    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    us = xd * fx + cx
    vs = yd * fy + cy

    # bilinear sample, the corner clamped to the image (no black fringes)
    u0 = torch.floor(us).clamp(0, W - 2)
    v0 = torch.floor(vs).clamp(0, H - 2)
    du = (us - u0).clamp(0.0, 1.0)
    dv = (vs - v0).clamp(0.0, 1.0)
    flat = img.reshape(-1)
    base = v0.long() * W + u0.long()
    g = lambda dy, dx: flat[base + (dy * W + dx)]
    out = ((1 - du) * (1 - dv) * g(0, 0) + du * (1 - dv) * g(0, 1)
           + (1 - du) * dv * g(1, 0) + du * dv * g(1, 1))
    inside = (us >= 0) & (us <= W - 1) & (vs >= 0) & (vs <= H - 1)
    return torch.where(inside, out, 0.0)


def undistort_image(image: np.ndarray, K: np.ndarray, distortion,
                    device=None) -> np.ndarray:
    """Undistort a grayscale image; coefficients (k1, k2, k3, p1, p2), fewer
    padded with zeros.  Returns the input itself when every coefficient is
    at most 1e-12 in size, else a numpy image of the input's dtype.  Runs
    on the CUDA device unless ``device`` names another."""
    d = np.zeros(5, np.float32)
    coef = np.ravel(distortion)[:5]
    d[:len(coef)] = coef
    if not np.any(np.abs(d) > 1e-12):
        return image
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "undistort_image runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    out = _undistort_core(
        img, torch.as_tensor(np.asarray(K, np.float32).reshape(3, 3),
                             device=dev),
        torch.as_tensor(d, device=dev))
    return out.cpu().numpy().astype(np.asarray(image).dtype)
