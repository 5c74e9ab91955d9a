"""line3dpp_tpu_torch — the line-based Multi-View Stereo engine in PyTorch.

The PyTorch/CUDA port of ``line3dpp_tpu``: the same configuration, cameras
and pipeline (epipolar line matching, 3D hypothesis scoring, affinity
clustering, TXT/STL/OBJ output), with hand-written CUDA kernels for an
NVIDIA Hopper GPU in place of the JAX package's Pallas kernels.  It imports
neither JAX nor ``line3dpp_tpu``.

This slice runs the default reconstruction from precomputed 2D segments;
``Line3D`` raises ``NotImplementedError`` for the options not ported yet.
"""

from .camera import Camera
from .config import Config
from .models.pipeline import Line3D
from .utils.writers import FinalLine3D

__all__ = ["Config", "Camera", "Line3D", "FinalLine3D"]
