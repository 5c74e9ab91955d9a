"""Pipeline configuration (PyTorch port).

A copy of ``line3dpp_tpu.config``: the same frozen dataclass, field names and
defaults, so one configuration drives either package.  The port implements
the default reconstruction path only; ``models.pipeline.Line3D`` raises
``NotImplementedError`` for the options it does not run yet.

A single frozen dataclass holds every tunable of the line-based MVS
engine.  Default values mirror the reference defaults (reference:
commons.h:40-100 and the CLI flags in main_vsfm.cpp:44-93) so that running with
an unmodified ``Config()`` reproduces the reference's golden configuration
``W_FULL, N_10, sigmaP_2.5, sigmaA_10, epiOverlap_0.25, kNN_10, vis_3``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Config:
    # --- feature detection (reference: commons.h:41-45) ---
    max_image_width: int = -1          # -1 == full resolution
    min_image_width: int = 800
    min_line_length_factor: float = 0.005   # fraction of image diagonal
    max_line_segments: int = 3000
    load_segments: bool = True         # cache detected 2D segments on disk
    # annealed extraction rounds of the TPU LSD (ops/lsd._lsd_core) and the
    # seed-angle gate on each round's initial rectangle fit (lsd.cpp-style
    # region-angle test, approximated by the strongest pixel's angle +
    # one re-admission refit).  DEFAULT OFF: measured on the golden
    # testdata (CPU detections, round 3) it nets NEGATIVE — seed-only
    # drops recall (count-F1 0.882 vs 0.8855 base), re-admission restores
    # single-segment coverage (0.876 vs 0.871) but the mod-pi alignment
    # re-admits anti-parallel edges and count-F1 falls to 0.878.
    lsd_rounds: int = 3
    lsd_seed_gate: bool = False
    # composed rect_improve rescue cascade (lsd.cpp:1756-1873: p/2 retry +
    # symmetric/one-sided width cuts, band-limited consumption).  The
    # reference runs rect_improve unconditionally; here it is OFF by
    # default after measuring NEUTRAL golden-residual support (round 5,
    # NEXT.md item l) at ~0.15 s/image extra device time.
    lsd_rescue: bool = False

    # --- collinearity (reference: commons.h:48) ---
    collinearity_t: float = -1.0       # <=0 disables collinearity edges

    # --- matching (reference: commons.h:51-56) ---
    num_neighbors: int = 10
    epipolar_overlap: float = 0.25
    knn: int = 10                      # kNN matches kept per (segment, neighbor)
    sigma_p: float = 2.5               # px if > 0, metric (world units) if < 0
    sigma_a: float = 10.0              # degrees
    check_match_orientation: bool = True
    # back-edge policy for the symmetrized match graph.  The reference
    # propagates inverse matches only *forward* in its sequential view loop
    # (storeInverseMatches line3D.cc:1672-1699 gates on !processed_[tgt]):
    # a view inherits candidates from earlier-processed views, never from
    # later ones.  "ordered" reproduces that by back-matching j->i only when
    # i precedes j in camID order; "full" symmetrizes both directions (the
    # round-1/2 behavior, a denser graph that over-merges near-duplicate
    # parallel lines); "none" keeps the raw neighbor lists only.
    match_symmetrization: str = "ordered"

    # --- scoring (reference: commons.h:59-61) ---
    min_similarity_3d: float = 0.50
    min_best_score_3d: float = 0.75
    min_best_score_perc: float = 0.10
    # per-SEGMENT relative score cut for affinity edges (no reference
    # counterpart — the reference's 10%-of-max cut is per VIEW,
    # filterMatches line3D.cc:1607-1612, so a weak cross-line match of a
    # strong segment survives it).  A kept match only produces an affinity
    # edge when score >= match_rel_cut * best_score(segment).  Measured on
    # the golden testdata (tools/diag_tail_ratio.py): same-line matches
    # score 0.90x their segment's best (median) while cross-line matches in
    # merged parallel bundles score 0.35x — the two populations separate.
    # <= 0 disables.
    match_rel_cut: float = 0.0

    # --- replicator dynamics diffusion (reference: commons.h:64-65) ---
    perform_rdd: bool = False
    rdd_max_iter: int = 10

    # --- clustering (reference: commons.h:68-69) ---
    min_affinity: float = 0.50
    visibility_t: int = 3
    felzenszwalb_c: float = 3.0        # adaptive threshold constant (line3D.cc:2089)
    # split clusters whose member hypotheses are bimodal across the fitted
    # line by >= this many sigma (pixel-equivalent k*depth units); close
    # parallel structure lines otherwise merge through estimate noise
    # (no reference counterpart — see pipeline._split_bimodal_clusters).
    # <= 0 disables.  DEFAULT OFF since round 3: the 1.1 calibration adds
    # +0.010 count-F1 on the golden testdata (0.8852 -> 0.8948, committed
    # TPU detections) but LOSES ~0.03 on an independent synthetic facade
    # by over-splitting clean clusters (SECOND_SCENE.md) — it is a
    # testdata-tuned compensation, not transferable geometry.  Re-enable
    # with Config(split_bimodal_t=1.1) / run_testdata --split=1.1.
    split_bimodal_t: float = 0.0
    # restrict the split DECISION to members whose best score is >= this
    # (score ~ confirming cameras; 3.0 = 3-camera-confirmed).  Merged
    # bundles carry a fog of 1-2-camera members with large depth errors
    # that dominated the all-member PCA axis and masked the lateral core
    # separation (tools/diag_bridge_classes.py).  <= 0: legacy all-member
    # behavior.
    split_strong_min: float = 0.0
    # two-tier bridge-resistant clustering (ops/clustering.py:
    # cluster_edges_anchored): nodes with best score >= this value (score ~
    # confirming cameras) are clustered first; weaker nodes may join a
    # strong cluster but never merge two of them.  Close parallel bundles
    # otherwise merge through chains of 1-2-camera fog estimates
    # (tools/diag_bridge_classes.py).  <= 0: single-pass reference
    # clustering.  No reference counterpart.
    cluster_strong_min: float = 0.0

    # --- bundling / optimization (reference: commons.h:83-88) ---
    optimize: bool = True              # batched LM line bundling (Ceres-equivalent)
    max_iter_optim: int = 250

    # --- numerics / execution ---
    const_regularization_depth: float = -1.0   # used when sigma_p < 0
    pair_chunk: int = 8                # view pairs per chunk of the plain matcher
    # JAX package only (fused Pallas kernel on TPU).  The port launches its
    # CUDA kernels exactly when the tensors are on a CUDA device.
    use_pallas_matching: bool = True
    view_block: int = -1               # >0: blocked large-scene matching;
                                       # bounds device memory at O(block*S*M)
    seg_pad: int = -1                  # pad segments per view; -1 -> max_line_segments
    match_slots: int = -1              # match slots per segment; -1 -> derived
    dtype: str = "float32"

    # derived constants (reference: commons.h:95-100)
    eps: float = 1e-12

    @property
    def two_sig_a_sqr(self) -> float:
        sig_a = min(abs(self.sigma_a), 90.0)
        return 2.0 * sig_a * sig_a

    @property
    def num_segments(self) -> int:
        return self.max_line_segments if self.seg_pad <= 0 else self.seg_pad

    @property
    def knn_effective(self) -> int:
        """kNN slots per (segment, pair).  kNN <= 0 keeps *all* valid
        matches, as the reference does (README.md:246, line3D.cc:973-988):
        every target segment gets a slot, so top-k over S candidates with
        k = S drops nothing.  Large scenes should combine this with
        ``view_block`` (the pipeline auto-blocks and warns otherwise)."""
        return self.knn if self.knn > 0 else self.num_segments

    @property
    def num_match_slots(self) -> int:
        """Total match slots per segment across all neighbor pairs."""
        if self.match_slots > 0:
            return self.match_slots
        return self.num_neighbors * self.knn_effective

    def filename_tag(self, width: int = -1) -> str:
        """Parameter-encoding output filename, mirroring line3D.cc:2855-2894."""
        w = "FULL" if width <= 0 else str(width)
        tag = (
            f"Line3D-TPU__W_{w}__N_{self.num_neighbors}"
            f"__sigmaP_{self.sigma_p:g}__sigmaA_{self.sigma_a:g}"
            f"__epiOverlap_{self.epipolar_overlap:g}__kNN_{self.knn}"
        )
        if self.perform_rdd:
            tag += "__DIFFUSION"
        if self.optimize:
            tag += "__OPTIMIZED"
        tag += f"__vis_{self.visibility_t}"
        if self.collinearity_t > 0:
            tag += f"__collin_{self.collinearity_t:g}"
        return tag


PI_1_32 = math.pi / 32.0      # reference: commons.h:99
PI_31_32 = math.pi * 31 / 32  # reference: commons.h:100
