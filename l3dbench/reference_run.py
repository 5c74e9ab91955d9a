"""The plain reference (``l3dbench/reference``) on one scene, and its
control in the precision below the configuration's.

The reference checks the program in two stages.  :func:`step` computes
the matches, scores and affinities from the scene's inputs alone.
:func:`recon` computes the 3D lines from the step's outputs that the
program produced (its estimates, affinities and median depths), so that a
match that rounding moves in the step does not hide the reconstruction's
own errors.

The configuration states float32 with TF32 off; the reference computes in
float64.  ``precision="tf32"`` is the control: the floats that each stage
reads (the segments and the cameras' arrays; in the reconstruction also
the program's estimates, affinities and depths) rounded to TF32's 10-bit
mantissa, as a tensor-core path would read them.
"""

from __future__ import annotations

import numpy as np

from .reference import options as options_mod
from .reference import recon as recon_mod
from .reference import scene as scene_mod
from .reference import step as step_mod

# what the comparison reads of the step (numpy), besides the neighbours
STEP_FIELDS = ("tgt", "valid", "score", "aff_weight", "aff_valid")


def step(options: dict, inputs: dict, device, precision: str = "fp32"):
    """The reference's step outputs on ``inputs`` (host arrays: the
    ``STEP_FIELDS``, ``nbr`` and ``knn``) and what the kernel counts
    read: the shapes, masks, neighbour table, pair validity and the scored
    slots after the orientation gate."""
    o = options_mod.resolve(options)
    sc = scene_mod.Scene(inputs, o, precision)
    out = step_mod.run(sc, o, device)
    res = {k: out[k].cpu().numpy() for k in STEP_FIELDS}
    res.update(nbr=sc.nbr, knn=o["knn"])
    V, S, M = res["tgt"].shape
    counts = dict(V=V, S=S, M=M, N=sc.nbr.shape[1], knn=o["knn"],
                  mask=sc.mask, neighbor_ids=sc.nbr,
                  pair_valid=sc.pair_valid,
                  score_valid=out["score_ok"].cpu().numpy())
    return res, counts


def recon(options: dict, inputs: dict, state: dict, device,
          precision: str = "fp32") -> np.ndarray | None:
    """The reference's 3D line segments (n, 6) on ``inputs`` from the
    program's step outputs ``state`` (see :func:`recon.run`); None where
    the state does not cover the scene's views and segments."""
    o = options_mod.resolve(options)
    sc = scene_mod.Scene(inputs, o, precision)
    if state["est_valid"].shape != sc.mask.shape:
        return None
    return recon_mod.run(sc, state, o, device, precision)
