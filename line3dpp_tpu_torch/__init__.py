"""line3dpp_tpu_torch — the line-based Multi-View Stereo engine in PyTorch.

The PyTorch/CUDA port of ``line3dpp_tpu``: the same configuration, cameras,
SfM readers (``io``), command line (``python -m
line3dpp_tpu_torch.cli.run``) and pipeline (LSD line-segment detection,
epipolar line matching, 3D hypothesis scoring, affinity clustering, line
bundling, TXT/STL/OBJ/BIN output), with hand-written CUDA kernels for an
NVIDIA Hopper GPU in place of the JAX package's Pallas kernels.  It imports
neither JAX nor ``line3dpp_tpu``.

It runs the reconstruction from images (``Line3D.add_image``,
``add_images``, or ``detect`` alone) or from precomputed 2D segments
(``Line3D.add_view``), reads and writes the reference's ``.bin`` formats
(``Line3D.save_bin``, ``load_bin``, ``load_reference_bin``) and undistorts
images (``undistort_image``).  Large scenes run phase 2 in blocks of
source views (``Config.view_block``, or automatically, as with ``knn <=
0``, which keeps every match); ``parallel`` shards the step's views over
the processes of a ``torch.distributed`` group.
"""

from . import io
from .camera import (Camera, decompose_projection_matrix, fundamental_matrix,
                     rotation_from_quaternion, rotation_from_rpy)
from .config import Config
from .models.pipeline import Line3D
from .ops.lsd import detect
from .ops.undistort import undistort_image
from .utils.ref_bin import load_reference_bin
from .utils.writers import FinalLine3D, load_bin


def detect_line_segments(image, max_width: int = -1, device=None):
    """Standalone 2D line-segment detection (reference:
    Line3D::detectLineSegments, line3D.cc:249-372); :func:`detect` with
    its defaults, on the CUDA device unless ``device`` names another."""
    return detect(image, max_width=max_width, device=device)


__version__ = "0.1.0"   # the JAX package's
__all__ = ["Config", "Camera", "Line3D", "FinalLine3D", "detect",
           "detect_line_segments", "load_bin", "load_reference_bin",
           "rotation_from_rpy", "rotation_from_quaternion",
           "decompose_projection_matrix", "fundamental_matrix",
           "undistort_image", "io"]
