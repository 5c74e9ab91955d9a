"""The system under test, ``line3dpp_tpu_torch``: its pipeline classes.
Imported by the run once it has found a card, so that the benchmark's own
modules import without the program."""

from __future__ import annotations

from line3dpp_tpu_torch.camera import Camera
from line3dpp_tpu_torch.config import Config
from line3dpp_tpu_torch.models.pipeline import Line3D

CLASSES = (Line3D, Config, Camera)
