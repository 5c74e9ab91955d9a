#!/usr/bin/env python3
"""Whether the padding of the views changes the port's lines: the facade
sweeps' configurations from JAX's facade detections, each run at
``seg_pad`` 256 and at the default 3000, the lines compared bit for bit.

    python tests/measure_torch_sweep_padding.py [--cpu] [NAME ...]

The detections are those of ``tests/make_torch_scene2_sweep_reference.py``
(JAX's 10 facade views at 3072 x 2304, at most 242 segments a view), and
``NAME`` is one of its configurations (``split_<t>_<sym>``,
``anchor_<a>``; all eight when none is named).
``tests/test_torch_drivers.py`` runs them at 256 on the CPU, where a
configuration at 3000 takes minutes; the drivers and the JAX reference
pad to 3000.  Runs on the CUDA device unless ``--cpu`` is given.  Prints a
line per configuration and, last, one JSON object: per configuration the
line counts, whether the lines are equal bit for bit, and each run's
seconds.  Not collected by pytest (its name does not start with test_).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_scene2_sweep_reference import (  # noqa: E402
    detections, sweep_options)

PADS = (256, 3000)


def lines_at(opts: dict, pad: int, cams, segs, device):
    """The lines of ``Line3D(Config(seg_pad=pad, **opts))`` fed ``segs``
    through ``add_view``, and the seconds they took."""
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.tools import synchronize

    t0 = time.perf_counter()
    pipe = lt.Line3D(lt.Config(seg_pad=pad, **opts), device=device)
    for i, (c, s) in enumerate(zip(cams, segs)):
        pipe.add_view(i, c, s)
    pipe.match_images()
    lines = [l.segments3d for l in pipe.reconstruct_3d_lines()]
    synchronize(pipe.device)
    return lines, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    from line3dpp_tpu_torch.tools import device_for
    from line3dpp_tpu_torch.utils import synthetic

    device = device_for("--cpu" in argv)
    every = sweep_options()
    names = [a for a in argv if not a.startswith("--")] or list(every)
    segs, W, H, _ = detections()
    cams = synthetic.make_cameras(len(segs), width=W, height=H)
    out = {}
    for name in names:
        (a, ta), (b, tb) = (lines_at(every[name], p, cams, segs, device)
                            for p in PADS)
        same = len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
        out[name] = dict(lines=[len(a), len(b)], bit_equal=same,
                         seconds=[ta, tb])
        print(f"{name}: {len(a)} lines at seg_pad {PADS[0]} "
              f"({ta:.1f} s), {len(b)} at {PADS[1]} ({tb:.1f} s), "
              f"bit-equal: {same}", flush=True)
    print(json.dumps({"device": device, "pads": PADS, "configs": out}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
