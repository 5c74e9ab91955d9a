"""The options of a scene, as the reference reads them: Line3D++'s
defaults (commons.h:40-100, main_vsfm.cpp:44-93) under the names of the
program's ``Config``, with a cell's keyword arguments over them.

The reference implements the paths that the benchmark's cells run: cached
segments, the nearest cameras as visual neighbours, a pixel ``sigma_p``,
kNN matching with ``knn > 0`` in one step, and the reconstruction with or
without collinearity, diffusion and bundling.  An option outside them
raises, so that a cell never passes for want of a reference.
"""

from __future__ import annotations

import math

DEFAULTS = dict(
    min_line_length_factor=0.005,   # of the image diagonal
    max_line_segments=3000,
    seg_pad=-1,
    collinearity_t=-1.0,            # px; <= 0: no collinearity edges
    num_neighbors=10,
    epipolar_overlap=0.25,
    knn=10,
    sigma_p=2.5,                    # px
    sigma_a=10.0,                   # degrees
    check_match_orientation=True,
    match_symmetrization="ordered",
    min_similarity_3d=0.5,
    min_best_score_3d=0.75,
    min_best_score_perc=0.10,
    perform_rdd=False,
    rdd_max_iter=10,
    min_affinity=0.5,
    visibility_t=3,
    felzenszwalb_c=3.0,
    optimize=True,
    max_iter_optim=250,
)
# options whose other values take paths that no cell runs
FIXED = dict(match_rel_cut=0.0, split_bimodal_t=0.0, split_strong_min=0.0,
             cluster_strong_min=0.0, view_block=-1, match_slots=-1,
             const_regularization_depth=-1.0, dtype="float32")
# options that change nothing the reference computes
IGNORED = {"load_segments", "max_image_width", "min_image_width",
           "lsd_rounds", "lsd_seed_gate", "lsd_rescue", "pair_chunk",
           "use_pallas_matching", "eps"}


def resolve(options: dict) -> dict:
    """``DEFAULTS`` with ``options`` over them, and the derived values
    ``S`` (segments a view), ``N0`` (neighbours asked for) and
    ``two_sig_a_sqr``."""
    o = dict(DEFAULTS)
    for key, value in options.items():
        if key in FIXED:
            if value != FIXED[key]:
                raise NotImplementedError(
                    f"the reference does not run {key}={value!r}")
        elif key in DEFAULTS:
            o[key] = value
        elif key not in IGNORED:
            raise KeyError(f"unknown option {key!r}")
    if o["knn"] <= 0 or o["sigma_p"] <= 0:
        raise NotImplementedError("the reference runs knn > 0 and a pixel "
                                  "sigma_p only")
    if o["match_symmetrization"] not in ("ordered", "full", "none"):
        raise ValueError(o["match_symmetrization"])
    o["S"] = o["max_line_segments"] if o["seg_pad"] <= 0 else o["seg_pad"]
    o["N0"] = max(o["num_neighbors"], 2)
    sig_a = min(abs(o["sigma_a"]), 90.0)
    o["two_sig_a_sqr"] = 2.0 * sig_a * sig_a
    o["visibility"] = max(o["visibility_t"], 3)
    o["deg"] = 180.0 / math.pi
    return o
