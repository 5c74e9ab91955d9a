"""SfM result readers (the L6 interface layer of the reference):
VisualSfM NVM, COLMAP, bundler, mavmap, Pix4D, OpenMVG.  Host parsers, a
copy of ``line3dpp_tpu.io``."""

from .types import SfMView
from .nvm import read_nvm
from .colmap import read_colmap
from .bundler import read_bundler
from .mavmap import read_mavmap, sequential_neighbors
from .pix4d import read_pix4d
from .openmvg import read_openmvg

__all__ = [
    "SfMView", "read_nvm", "read_colmap", "read_bundler", "read_mavmap",
    "read_pix4d", "read_openmvg", "sequential_neighbors",
]
