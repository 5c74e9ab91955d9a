"""line3dpp_tpu_torch — the line-based Multi-View Stereo engine in PyTorch.

The PyTorch/CUDA port of ``line3dpp_tpu``: the same configuration, cameras
and pipeline (LSD line-segment detection, epipolar line matching, 3D
hypothesis scoring, affinity clustering, TXT/STL/OBJ output), with
hand-written CUDA kernels for an NVIDIA Hopper GPU in place of the JAX
package's Pallas kernels.  It imports neither JAX nor ``line3dpp_tpu``.

It runs the default reconstruction from images (``Line3D.add_image``,
``add_images``, or ``detect`` alone) or from precomputed 2D segments
(``Line3D.add_view``), reads and writes the reference's ``.bin`` formats
(``Line3D.save_bin``, ``load_bin``, ``load_reference_bin``) and undistorts
images (``undistort_image``); the options not ported yet raise
``NotImplementedError``.
"""

from .camera import Camera
from .config import Config
from .models.pipeline import Line3D
from .ops.lsd import detect
from .ops.undistort import undistort_image
from .utils.ref_bin import load_reference_bin
from .utils.writers import FinalLine3D, load_bin

__all__ = ["Config", "Camera", "Line3D", "FinalLine3D", "detect",
           "load_bin", "load_reference_bin", "undistort_image"]
