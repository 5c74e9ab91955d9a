"""Common SfM view record returned by every reader."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SfMView:
    """One posed image as read from an SfM result.

    Mirrors the data each reference executable assembles before calling
    addImage (e.g. main_vsfm.cpp:252-310): intrinsics, pose, image path,
    radial/tangential distortion, observed worldpoint ids, and the median
    scene depth of those worldpoints.
    """

    cam_id: int
    K: np.ndarray                 # (3,3)
    R: np.ndarray                 # (3,3) world->cam
    t: np.ndarray                 # (3,)
    image_path: str
    width: int = -1               # -1: read from the image file
    height: int = -1
    distortion: np.ndarray | None = None   # (k1,k2,k3,p1,p2) or None
    worldpoints: list[int] | None = None
    median_depth: float = 1.0


def loud_parser(fmt_name: str):
    """Wrap an SfM reader so malformed/truncated files raise one clear
    ValueError naming the file and format instead of leaking StopIteration
    or a bare index error (the reference exits(1) on unreadable archives,
    serialization.h:52-55; we fail loudly without killing the process)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(path, *args, **kwargs):
            try:
                return fn(path, *args, **kwargs)
            except (StopIteration, ValueError, IndexError, KeyError,
                    RuntimeError, EOFError, struct_error) as e:
                raise ValueError(
                    f"malformed {fmt_name} input '{path}': "
                    f"{type(e).__name__}: {e}") from e
        return wrapper
    return deco


try:
    from struct import error as struct_error
except ImportError:                       # pragma: no cover
    struct_error = ValueError
