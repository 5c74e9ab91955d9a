"""One scene through the program's ``Line3D`` pipeline: what the window
times, and what the comparison reads back.

A scene is what ``line3dpp_tpu_torch.bench.images_e2e`` times, from cached
segments: a fresh ``Line3D`` under the cell's ``Config``, ``add_view`` for
each view, ``match_images`` and ``reconstruct_3d_lines``, ended by a device
synchronize, so that the lines are on the host.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

# the step outputs (models/step.StepOutputs) that the reference's
# reconstruction reads
STATE_FIELDS = ("tgt_seg", "aff_weight", "aff_valid", "est_valid", "est_P1",
                "est_P2", "est_d1", "est_d2", "median_depth")


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scene(classes, options: dict, inputs: dict, device, traced=False):
    """Runs ``inputs`` through a new pipeline of ``classes`` (``Line3D``,
    ``Config``, ``Camera``) on ``device``.  Returns the pipeline and, when
    ``traced``, the host seconds of each phase, each under a profiler span
    ``l3dbench.<phase>`` and ended by a synchronize."""
    Line3D, Config, Camera = classes
    device = torch.device(device)
    phases = {}

    @contextlib.contextmanager
    def phase(name):
        if not traced:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"l3dbench.{name}"):
            yield
            synchronize(device)
        phases[name] = time.perf_counter() - t0

    pipe = Line3D(Config(**options), device=device)
    cams = [(v[0], Camera(v[1], v[2], v[3], v[4], v[5]), v[6])
            for v in inputs["views"]]
    with phase("add_views"):
        for cam_id, cam, segs in cams:
            pipe.add_view(cam_id, cam, segs)
    with phase("match_images"):
        pipe.match_images()
    with phase("reconstruct_3d_lines"):
        pipe.reconstruct_3d_lines()
    synchronize(device)
    return pipe, phases


def outputs(pipe) -> dict:
    """What the comparison judges, on the host: the step's matches, scores
    and affinities (``step``), the step's outputs that the reconstruction
    reads (``state``), and the 3D line segments (n, 6) with the line
    count."""
    st = pipe._last_state
    out = st["out"]
    host = lambda name: getattr(out, name).cpu().numpy()  # noqa: E731
    state = {k: host(k) for k in STATE_FIELDS}
    state["neighbor_ids"] = np.asarray(st["neighbor_ids"])
    step = dict(tgt=state["tgt_seg"], valid=host("match_valid"),
                score=host("score3d"), aff_weight=state["aff_weight"],
                aff_valid=state["aff_valid"], nbr=state["neighbor_ids"],
                knn=int(st["knn"]))
    return dict(step=step, state=state,
                lines=np.concatenate(
                    [np.asarray(l.segments3d, np.float64).reshape(-1, 6)
                     for l in pipe.lines3d] or [np.zeros((0, 6))]),
                n_lines=len(pipe.lines3d))
