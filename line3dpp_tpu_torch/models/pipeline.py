"""Line3D pipeline orchestrator (PyTorch port).

The counterpart of ``line3dpp_tpu.models.pipeline.Line3D`` and of the
reference's ``L3DPP::Line3D`` class (reference: line3D.h:61-424): owns views,
runs

    [1] view ingestion  ->  [2] line matching  ->  [3] reconstruction

and writes the resulting 3D line model.  Phase 2 is one fused device step
(``models/step.py``) on ``self.device``; phase 3 is host numpy, apart from
the relative score cut, collinearity, RDD, line bundling and the interval
sweep, which run on ``self.device``.

The port runs every ``Config`` option, from images (LSD detection,
``add_image``/``add_images``) or from precomputed segments (``add_view``),
with the optional stages of the reconstruction: the relative score cut
(``match_rel_cut``), collinearity edges (``collinearity_t``,
``ops/collinearity.py``), replicator-dynamics diffusion (``perform_rdd``,
``ops/rdd.py``), anchored clustering (``cluster_strong_min``) and the
bimodal split (``split_bimodal_t``, ``split_strong_min``).  Large scenes
run phase 2 in blocks of source views (``view_block``, or automatically
once a match tensor would pass 2 GiB, as with ``knn <= 0``, which keeps
every match): ``_match_images_blocked``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..camera import (Camera, CameraBatch, fundamental_matrices,
                      median_center_translation)
from .. import obs
from ..config import Config
from ..ops import affinity as affinity_ops
from ..ops import bundling as bundling_ops
from ..ops import clustering as clustering_ops
from ..ops import collinearity as collin_ops
from ..ops import fitting as fitting_ops
from ..ops import geometry as geo
from ..ops import lsd as lsd_ops
from ..ops import rdd as rdd_ops
from ..ops import sweep as sweep_ops
from ..utils import segments_cache
from ..utils import ref_bin
from ..utils.writers import FinalLine3D, save_bin, save_obj, save_stl, \
    save_txt
from .step import _match_score_filter, forward_step

EPS = 1e-12
# the array arguments of models.step.forward_step, in order
STEP_ARRAYS = ("segments", "seg_mask", "RtKinv", "C", "k_reg",
               "neighbor_ids", "F", "pair_valid")


@dataclasses.dataclass
class _ViewEntry:
    cam_id: int
    camera: Camera
    segments: np.ndarray     # (n, 4) float
    worldpoints: list | None


class Line3D:
    """End-to-end line-based MVS pipeline.

    ``device`` defaults to ``"cuda"``; without a CUDA device the constructor
    raises unless the caller passes ``device="cpu"``, which runs the plain
    PyTorch version of every kernel."""

    def __init__(self, config: Config | None = None,
                 device: str | torch.device | None = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Line3D runs on a CUDA device by default and none is "
                    "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.config = config or Config()
        self._views: dict[int, _ViewEntry] = {}
        self._fixed_neighbors: dict[int, list[int]] = {}
        self.lines3d: list[FinalLine3D] = []
        # the detector's diagnostic counts of the last add_images call
        self.detect_stats: list[dict] = []
        # line bundling's counts in the last reconstruct_3d_lines call
        # (ops.bundling.optimize_cluster_lines' stats; empty when it did
        # not bundle)
        self.bundle_stats: dict = {}
        # the sweep's counts in the last reconstruct_3d_lines call
        # (ops.sweep.sweep_clusters' stats; empty when it did not sweep)
        self.sweep_stats: dict = {}
        self._last_state: dict = {}
        # opt-in diagnostics, the JAX package's: set to [] before
        # reconstruct_3d_lines to collect one record per bimodal-split
        # candidate, and one per cluster with its fate
        self._split_records: list | None = None
        self._cluster_records: list | None = None

    # ------------------------------------------------------------------
    # phase 1: view ingestion (reference: addImage line3D.cc:112-227)
    # ------------------------------------------------------------------
    def add_view(self, cam_id: int, camera: Camera, segments: np.ndarray,
                 worldpoints: Sequence[int] | None = None) -> None:
        """Register a view with precomputed 2D segments (the
        ``line_segments`` path of addImage, reference: line3D.h:104-108)."""
        with obs.span("add_view", self):
            segments = np.asarray(segments, dtype=np.float64).reshape(-1, 4)
            # min-length filter + keep longest max_line_segments
            # (reference: line3D.cc:320-360)
            lengths = np.hypot(segments[:, 2] - segments[:, 0],
                               segments[:, 3] - segments[:, 1])
            min_len = camera.diagonal * self.config.min_line_length_factor
            segments = segments[lengths >= min_len]
            lengths = lengths[lengths >= min_len]
            if len(segments) > self.config.max_line_segments:
                keep = np.argsort(-lengths, kind="stable")[
                    : self.config.max_line_segments]
                keep.sort()
                segments = segments[keep]
            self._views[cam_id] = _ViewEntry(
                cam_id, camera, segments,
                list(worldpoints) if worldpoints is not None else None)

    def add_image(self, cam_id: int, camera: Camera, image: np.ndarray,
                  worldpoints: Sequence[int] | None = None,
                  cache_dir: str | None = None) -> None:
        """Register a view, detecting its 2D segments with the LSD detector
        on ``self.device`` (reference: line3D.cc:249-372)."""
        self.add_images([(cam_id, camera, image, worldpoints)], cache_dir)

    def add_images(self, items: Sequence[tuple],
                   cache_dir: str | None = None) -> None:
        """Register several views at once.

        ``items`` holds ``(cam_id, camera, image)`` or ``(cam_id, camera,
        image, worldpoints)`` tuples.  Images narrower than
        ``min_image_width`` are skipped (line3D.cc:119-126); with
        ``cache_dir`` (and ``load_segments``) cached segments are read
        instead of detected, and new detections are stored.
        ``self.detect_stats`` then holds one dict of the detector's counts
        (``ops.lsd._lsd_core``: active pixels, components and acceptances
        per round, ``n_rescue``, ``n_split``) per image detected by this
        call, in order."""
        with obs.span("add_images", self):
            self._add_images(items, cache_dir)

    def _add_images(self, items: Sequence[tuple],
                    cache_dir: str | None) -> None:
        cfg = self.config
        self.detect_stats = []
        use_cache = bool(cache_dir) and cfg.load_segments
        todo = []          # (cam_id, camera, image, wps) needing detection
        for it in items:
            cam_id, camera, image = it[0], it[1], it[2]
            wps = it[3] if len(it) > 3 else None
            width = image.shape[1] if image.ndim >= 2 else 0
            if width < cfg.min_image_width:
                print(f"[L3D-TPU] warning: image {cam_id} too small "
                      f"({width} < {cfg.min_image_width} px wide) -> "
                      f"skipped", flush=True)
                continue
            segs = None
            if use_cache:
                segs = segments_cache.load(cache_dir, cam_id, image.shape,
                                           cfg.max_line_segments,
                                           cfg.max_image_width)
            if segs is None:
                todo.append((cam_id, camera, image, wps))
            else:
                self.add_view(cam_id, camera, segs, wps)
        if not todo:
            return
        seg_lists = lsd_ops.detect_batch(
            [t[2] for t in todo], max_width=cfg.max_image_width,
            rescue=cfg.lsd_rescue, n_rounds=cfg.lsd_rounds,
            seed_gate=cfg.lsd_seed_gate, device=self.device,
            stats=self.detect_stats)
        for (cam_id, camera, image, wps), segs in zip(todo, seg_lists):
            if use_cache:
                segments_cache.store(cache_dir, cam_id, image.shape,
                                     cfg.max_line_segments, segs,
                                     cfg.max_image_width)
            self.add_view(cam_id, camera, segs, wps)

    def set_visual_neighbors(self, cam_id: int,
                             neighbors: Sequence[int]) -> None:
        """Explicit neighbor list (reference: line3D.cc:230-246)."""
        self._fixed_neighbors[cam_id] = list(neighbors)

    # ------------------------------------------------------------------
    # phase 2: matching, scoring, filtering, affinity
    # ------------------------------------------------------------------
    def step_inputs(self) -> dict:
        """Host-side set-up of phase 2: the arrays ``forward_step`` takes
        (``segments``, ``seg_mask``, ``RtKinv``, ``C``, ``k_reg``,
        ``neighbor_ids``, ``F``, ``pair_valid``, all numpy) and the
        bookkeeping the reconstruction needs (``cam_ids``, ``cams``,
        ``translation``, ``cb``, ``knn``)."""
        cfg = self.config
        cam_ids = sorted(self._views)
        V = len(cam_ids)
        if V == 0:
            raise ValueError("no views added")
        S = cfg.num_segments
        N = max(cfg.num_neighbors, 2)
        k = cfg.knn_effective

        id2idx = {c: i for i, c in enumerate(cam_ids)}
        cams = [self._views[c].camera for c in cam_ids]

        # median-centering for float32 stability (line3D.cc:500-536)
        translation = median_center_translation(cams)
        fixed_reg = cfg.sigma_p < 0
        med_scene_depth = cfg.const_regularization_depth
        if fixed_reg and med_scene_depth < 0:
            depths = sorted(c.median_depth for c in cams)
            med_scene_depth = depths[len(depths) // 2]
        cb = CameraBatch.from_cameras(
            cams, cfg.sigma_p, translation,
            med_scene_depth if fixed_reg else None, fixed_reg)

        # dense segment tensors
        segs = np.zeros((V, S, 4), np.float32)
        mask = np.zeros((V, S), bool)
        for i, c in enumerate(cam_ids):
            sv = self._views[c].segments[:S]
            segs[i, : len(sv)] = sv
            mask[i, : len(sv)] = True

        # visual neighbors -> (V, N) neighbor table + pair validity, with
        # back-edges per cfg.match_symmetrization: "ordered" adds j->i only
        # when i precedes j, as the reference's order-gated
        # storeInverseMatches (line3D.cc:1672-1699)
        nbr_lists = self._visual_neighbors(cam_ids, cams, N)
        nbr_sets: dict[int, list[int]] = {
            c: [id2idx[n] for n in nbr_lists[c] if n in id2idx][:N]
            for c in cam_ids
        }
        sym = cfg.match_symmetrization
        if sym not in ("full", "ordered", "none"):
            raise ValueError(f"match_symmetrization={sym!r}")
        if sym != "none":
            for i, c in enumerate(cam_ids):
                for j in nbr_sets[c]:
                    back = nbr_sets[cam_ids[j]]
                    if i not in back and (sym == "full" or i < j):
                        back.append(i)
        N = max(N, max((len(v) for v in nbr_sets.values()), default=N))
        neighbor_ids = np.zeros((V, N), np.int32)
        pair_valid = np.zeros((V, N), bool)
        for i, c in enumerate(cam_ids):
            nl = nbr_sets[c]
            neighbor_ids[i, : len(nl)] = nl
            pair_valid[i, : len(nl)] = True

        # fundamental matrices per (view, neighbor slot), one batched pass
        F = np.zeros((V, N, 3, 3), np.float32)
        centered = [Camera(c.K, c.R, -c.R @ (c.C - translation), c.width,
                           c.height) for c in cams]
        src_p, slot_p = np.nonzero(pair_valid)
        if len(src_p):
            F[src_p, slot_p] = fundamental_matrices(
                centered, src_p, neighbor_ids[src_p, slot_p])

        return dict(segments=segs, seg_mask=mask, RtKinv=cb.RtKinv, C=cb.C,
                    k_reg=cb.k_reg, neighbor_ids=neighbor_ids, F=F,
                    pair_valid=pair_valid, cam_ids=cam_ids, cams=cams,
                    translation=translation, cb=cb, knn=k,
                    view_block=self._view_block(V, S, N, k))

    def _view_block(self, V: int, S: int, N: int, k: int) -> int:
        """Source views per block of phase 2 (0: the fused step).  The
        fused step's [V, S, N*k] tensors can exceed device memory in the
        all-matches mode (knn <= 0) or on very large scenes: above 2 GiB
        per array, without a ``view_block``, the JAX package's rule picks
        a block that keeps about 2 GiB per array, and says so.  N is the
        neighbour width after symmetrization."""
        view_block = self.config.view_block
        fused_bytes = V * S * N * k * 4
        if view_block <= 0 and fused_bytes > (2 << 30):
            view_block = max(1, (2 << 30) // max(S * N * k * 4, 1))
            print(
                f"[L3D-TPU] match tensors would be {fused_bytes / (1 << 30):.1f}"
                f" GiB per array (knn={self.config.knn}); auto-blocking source "
                f"views at view_block={view_block}", flush=True)
        return view_block if 0 < view_block < V else 0

    def _step_options(self) -> dict:
        cfg = self.config
        return dict(epipolar_overlap=cfg.epipolar_overlap,
                    two_sig_a_sqr=cfg.two_sig_a_sqr,
                    min_similarity=cfg.min_similarity_3d,
                    check_orientation=cfg.check_match_orientation,
                    min_best_score=cfg.min_best_score_3d,
                    min_best_score_perc=cfg.min_best_score_perc,
                    pair_chunk=max(cfg.pair_chunk, 1))

    def match_images(self) -> None:
        with obs.span("match_images", self):
            self._match_images()

    def _match_images(self) -> None:
        cfg = self.config
        dev = self.device
        with obs.span("step.inputs"):
            inp = self.step_inputs()
            arrays = {n: torch.from_numpy(inp[n]).to(dev)
                      for n in STEP_ARRAYS}
            r1, r2 = geo.segment_rays(arrays["RtKinv"][:, None],
                                      arrays["segments"])
        state = dict(
            cam_ids=inp["cam_ids"], cams=inp["cams"],
            translation=inp["translation"], cb=inp["cb"],
            segs=inp["segments"], segments=arrays["segments"],
            mask=inp["seg_mask"],
            neighbor_ids=inp["neighbor_ids"], knn=inp["knn"], r1=r1, r2=r2)
        if inp["view_block"]:
            # large-scene path: source views in blocks, so that device
            # memory stays O(block * S * M) whatever V is
            state.update(self._match_images_blocked(
                arrays, inp["knn"], inp["view_block"]))
        else:
            out = forward_step(**arrays, knn=inp["knn"],
                               min_affinity=cfg.min_affinity,
                               **self._step_options())
            state.update(out=out, est=out, median_depth=out.median_depth)
        self._last_state = state

    def _match_images_blocked(self, arrays: dict, k: int,
                              view_block: int) -> dict:
        """Blocked matching for scenes too large for the fused step: the
        source views run through ``_match_score_filter`` in blocks of
        ``view_block`` rows (device memory O(block * S * M)), each block's
        kept matches are compacted to a flat edge list (block order,
        row-major inside a block), and the affinity is evaluated edge by
        edge over the global estimate tables (the counterpart of
        ``line3dpp_tpu.models.pipeline.Line3D._match_images_blocked``).
        K1 and K2 launch once per block; K3 does not run.  Returns the
        state that ``reconstruct_3d_lines`` reads."""
        cfg = self.config
        seg_mask = arrays["seg_mask"]
        V, S = seg_mask.shape
        N = arrays["neighbor_ids"].shape[1]
        M = N * k
        dev, f32 = self.device, torch.float32
        est_P1 = torch.zeros((V, S, 3), dtype=f32, device=dev)
        est_P2 = torch.zeros((V, S, 3), dtype=f32, device=dev)
        est_d1 = torch.zeros((V, S), dtype=f32, device=dev)
        est_d2 = torch.zeros((V, S), dtype=f32, device=dev)
        est_valid = torch.zeros((V, S), dtype=torch.bool, device=dev)
        # views of a block with no kept estimate keep EPS, as in JAX
        median_depth = torch.full((V,), EPS, dtype=f32, device=dev)
        nbr = arrays["neighbor_ids"].cpu().numpy()
        edges = []                                   # (sv, ss, tv, ts)
        for lo in range(0, V, view_block):
            with obs.span("step.block"):
                hi = min(lo + view_block, V)
                msf = _match_score_filter(
                    arrays["segments"], seg_mask, arrays["RtKinv"],
                    arrays["C"], arrays["k_reg"],
                    arrays["neighbor_ids"][lo:hi], arrays["F"][lo:hi],
                    arrays["pair_valid"][lo:hi], knn=k,
                    src_rows=torch.arange(lo, hi, dtype=torch.int32),
                    **self._step_options())
                fm = msf["fm"]
                est_P1[lo:hi] = fm.est_P1
                est_P2[lo:hi] = fm.est_P2
                est_d1[lo:hi] = fm.est_d1
                est_d2[lo:hi] = fm.est_d2
                est_valid[lo:hi] = fm.est_valid
                median_depth[lo:hi] = msf["median_depth"]
                idx, ts = affinity_ops.compact_kept(fm.kept, msf["t_seg"])
                del msf, fm
                lv = idx // (S * M)
                slot = idx % M
                edges.append((lo + lv, (idx // M) % S,
                              nbr[lo + lv, slot // k], ts))

        with obs.span("step.affinity"):
            med = median_depth.cpu().numpy()
            meds = np.sort(med[med > EPS])
            med_scene = float(meds[len(meds) // 2]) if len(meds) else 0.0
            sv, ss, tv, ts = (np.concatenate(x).astype(np.int64)
                              for x in zip(*edges))
            to_dev = lambda x: torch.from_numpy(x).to(dev)
            w, valid = affinity_ops.affinity_edges_flat(
                est_P1, est_P2, est_d1, est_d2, est_valid, to_dev(sv),
                to_dev(ss), to_dev(tv), to_dev(ts),
                torch.ones(len(sv), dtype=torch.bool, device=dev),
                arrays["k_reg"], median_depth, med_scene, cfg.two_sig_a_sqr,
                cfg.min_affinity)
            valid = valid.cpu().numpy()
            ww = w.cpu().numpy()[valid]
        est = affinity_ops.FilteredMatches(
            kept=None, est_valid=est_valid, est_P1=est_P1, est_P2=est_P2,
            est_d1=est_d1, est_d2=est_d2, max_score=None)
        return dict(est=est, median_depth=median_depth,
                    edges_flat=(sv[valid] * S + ss[valid],
                                tv[valid] * S + ts[valid], ww))

    # ------------------------------------------------------------------
    # phase 3: clustering, line fit, sweep
    # ------------------------------------------------------------------
    def reconstruct_3d_lines(self) -> list[FinalLine3D]:
        with obs.span("reconstruct_3d_lines", self):
            self.lines3d = self._reconstruct_3d_lines()
        return self.lines3d

    def _reconstruct_3d_lines(self) -> list[FinalLine3D]:
        """:meth:`reconstruct_3d_lines`'s stages, each under its span
        ``recon.*``; returns the lines."""
        cfg = self.config
        st = self._last_state
        if not st:
            raise RuntimeError("call match_images() first")
        self.bundle_stats = {}
        self.sweep_stats = {}
        cam_ids, cb, est = st["cam_ids"], st["cb"], st["est"]
        V, S = st["mask"].shape
        visibility = max(cfg.visibility_t, 3)
        # the fused step's dense outputs; the blocked path keeps none, so
        # it applies no match_rel_cut and no score-anchored clustering or
        # split, as the JAX package's
        out = st.get("out")

        with obs.span("recon.edges"):
            if out is None:
                # the blocked large-scene path delivered the edges
                gid_a, gid_b, ww = st["edges_flat"]
            else:
                M = out.tgt_seg.shape[2]
                # optional per-segment relative score cut
                # (Config.match_rel_cut): a kept match yields an affinity
                # edge only when its score is at least rel * the segment's
                # best kept score; on the device
                aff = affinity_ops.AffinityDense(out.aff_weight,
                                                 out.aff_valid)
                if cfg.match_rel_cut > 0:
                    aff = affinity_ops.rel_cut(aff, out.score3d, out.kept,
                                               cfg.match_rel_cut)

                # --- edge extraction: device-side compaction, then host
                # dedup (line3D.cc:1881-1899).  Only O(E) values cross to
                # the host.
                idx, ww, ts_e = affinity_ops.compact_edges(aff,
                                                           out.tgt_seg)
                src_v = idx // (S * M)
                src_s = (idx // M) % S
                tv_e = st["neighbor_ids"][src_v, (idx % M) // st["knn"]]
                gid_a = src_v * S + src_s
                gid_b = tv_e.astype(np.int64) * S + ts_e

        # optional collinearity edges: same-view collinear segment pairs
        # with consistent 3D estimates (line3D.cc:1904-1974), compacted on
        # the device (on the card by one kernel, csrc/collinearity.cu)
        if cfg.collinearity_t > 0:
            med = st["median_depth"].cpu().numpy()
            meds = np.sort(med[med > EPS])
            med_scene = float(meds[len(meds) // 2]) if len(meds) else 0.0
            dev = self.device
            cv_, cs1, cs2, cw = collin_ops.collinear_edges(
                torch.from_numpy(st["segs"]).to(dev),
                torch.from_numpy(st["mask"]).to(dev),
                est.est_P1, est.est_P2, est.est_d1, est.est_d2,
                est.est_valid, torch.from_numpy(cb.k_reg).to(dev),
                st["median_depth"], med_scene, float(cfg.collinearity_t),
                cfg.min_affinity)
            gid_a = np.concatenate([gid_a, cv_ * S + cs1])
            gid_b = np.concatenate([gid_b, cv_ * S + cs2])
            ww = np.concatenate([ww, cw])

        with obs.span("recon.dedup"):
            lo = np.minimum(gid_a, gid_b)
            hi = np.maximum(gid_a, gid_b)
            _, first = np.unique(lo * (V * S) + hi, return_index=True)
            lo, hi, ww = lo[first], hi[first], ww[first]

            if len(ww) == 0:
                return []

            # local node ids for nodes that appear in edges
            nodes, inv = np.unique(np.concatenate([lo, hi]),
                                   return_inverse=True)
            li = inv[: len(lo)].astype(np.int32)
            lj = inv[len(lo):].astype(np.int32)

        # optional replicator-dynamics diffusion sharpens the affinities
        # before clustering (performRDD line3D.cc:2026-2076)
        if cfg.perform_rdd:
            ww = rdd_ops.rdd_edges(li, lj, ww.astype(np.float32), len(nodes),
                                   iterations=cfg.rdd_max_iter,
                                   device=self.device)

        with obs.span("recon.cluster"):
            # both directions, as the reference pushes symmetric entries
            ei = np.concatenate([li, lj])
            ej = np.concatenate([lj, li])
            ew = np.concatenate([ww, ww]).astype(np.float32)
            if cfg.cluster_strong_min > 0 and out is not None:
                best = affinity_ops.best_kept_score(out.score3d, out.kept)
                strong_node = best.cpu().numpy()[nodes // S, nodes % S] \
                    >= cfg.cluster_strong_min
                labels = clustering_ops.cluster_edges_anchored(
                    ei, ej, ew, len(nodes), strong_node, cfg.felzenszwalb_c)
            else:
                labels = clustering_ops.cluster_edges(ei, ej, ew, len(nodes),
                                                      cfg.felzenszwalb_c)

            # --- group nodes into clusters with >= visibility distinct
            # cameras
            node_view = (nodes // S).astype(np.int32)
            node_seg = (nodes % S).astype(np.int32)
            uniq_labels, label_inv = np.unique(labels, return_inverse=True)
            n_clusters = len(uniq_labels)
            pairs = np.unique(np.stack([label_inv, node_view], 1), axis=0)
            cams_per_cluster = np.bincount(pairs[:, 0], minlength=n_clusters)
            keep_cluster = cams_per_cluster >= visibility
            cluster_remap = np.cumsum(keep_cluster) - 1
            member_ok = keep_cluster[label_inv]

            mc = cluster_remap[label_inv[member_ok]].astype(np.int32)
            mv = node_view[member_ok]
            ms = node_seg[member_ok]
            C = int(keep_cluster.sum())
            if self._cluster_records is not None:
                for lab in np.flatnonzero(~keep_cluster):
                    self._cluster_records.append(
                        {"outcome": "visibility",
                         "nodes": nodes[label_inv == lab]})
            if C == 0:
                return []

        with obs.span("recon.fit"):
            # --- line fit from member hypothesis endpoints
            estP1 = est.est_P1.cpu().numpy()
            estP2 = est.est_P2.cpu().numpy()
            pts = np.concatenate([estP1[mv, ms], estP2[mv, ms]], axis=0)
            lines = fitting_ops.fit_lines_np(pts, np.concatenate([mc, mc]), C)
            lineP1, lineP2 = lines.P1, lines.P2
            line_dir = lineP2 - lineP1
            line_dir /= np.maximum(
                np.linalg.norm(line_dir, axis=-1, keepdims=True), EPS)

            # --- optional split of clusters whose member hypotheses are
            # bimodal across the fitted line (host, on the step's estimates)
            if cfg.split_bimodal_t > 0:
                m_score = None
                if cfg.split_strong_min > 0 and out is not None:
                    m_score = affinity_ops.best_kept_score(
                        out.score3d, out.kept).cpu().numpy()[mv, ms]
                mc, C, lineP1, lineP2, line_dir = self._split_bimodal_clusters(
                    mc, mv, ms, C, lineP1, line_dir, estP1, estP2,
                    dict(cb=cb, median_depth=st["median_depth"].cpu().numpy()),
                    visibility, cfg.split_bimodal_t, m_score=m_score,
                    strong_min=cfg.split_strong_min)

        # --- optional bundling of the cluster lines (optimization.cc)
        if cfg.optimize:
            lineP1, _, line_dir = bundling_ops.optimize_cluster_lines(
                lineP1, lineP2, mc, mv, ms, C, st, cfg, device=self.device,
                stats=self.bundle_stats)

        with obs.span("recon.sweep"):
            # --- the members in cluster order, shared with the assembly
            order, bounds = sweep_ops.cluster_csr(mc, C)
            # --- member segments projected onto their cluster lines, the
            # interval sweep (line3D.cc:2342-2452, flat arrays) and the
            # reference view per cluster, the camera of its longest member
            # 2D segment (line3D.cc:2183-2189): one kernel on the card
            iv_c, iv_sa, iv_sb, ref_view = sweep_ops.sweep_clusters(
                st["r1"], st["r2"], st["segments"], cb.C, lineP1, line_dir,
                mc, mv, ms, C, visibility, csr=(order, bounds),
                stats=self.sweep_stats)

        with obs.span("recon.assemble"):
            # --- assemble + tiny-segment filter (line3D.cc:2302-2339)
            translation = st["translation"]
            cams = st["cams"]
            seg2d = st["segs"]

            # interval endpoints back to original world coordinates
            # (untranslate, line3D.cc:539-545)
            d_iv = line_dir[iv_c]
            Pa = lineP1[iv_c] + iv_sa[:, None] * d_iv + translation
            Pb = lineP1[iv_c] + iv_sb[:, None] * d_iv + translation

            # tiny filter: projected length in each cluster's reference view
            rv = ref_view[iv_c]
            Rs = np.stack([cam.R for cam in cams])
            ts_ = np.stack([cam.t for cam in cams])
            Ks = np.stack([cam.K for cam in cams])
            diags = np.array([cam.diagonal for cam in cams])

            def _proj(P: np.ndarray) -> np.ndarray:
                q = np.einsum("nij,nj->ni", Rs[rv], np.asarray(P, np.float64))
                q += ts_[rv]
                q = q / q[:, 2:3]
                uv = np.einsum("nij,nj->ni", Ks[rv], q)
                return uv[:, :2] / uv[:, 2:3]

            if len(iv_c):
                lens_uv = np.linalg.norm(_proj(Pa) - _proj(Pb), axis=-1)
            else:
                lens_uv = np.zeros(0)
            iv_keep = lens_uv > diags[rv] * cfg.min_line_length_factor

            # residual rows for every member at once: [camID segID p q]
            res_all = np.column_stack([
                np.asarray(cam_ids, np.float64)[mv], ms.astype(np.float64),
                seg2d[mv, ms].astype(np.float64)])

            seg_rows = np.concatenate([Pa, Pb], axis=1)[iv_keep]
            kc = iv_c[iv_keep]          # already ascending (sweep order)
            kbounds = np.searchsorted(kc, np.arange(C + 1))
            emit = np.bincount(kc, minlength=C) > 0
            if self._cluster_records is not None:
                swept = np.bincount(iv_c, minlength=C) > 0
                # exclusive prefix: the index of each emitted cluster's line
                line_idx = np.cumsum(emit) - emit
                for c in range(C):
                    members = order[bounds[c]: bounds[c + 1]]
                    self._cluster_records.append({
                        "outcome": ("emitted" if emit[c] else
                                    "tiny" if swept[c] else "sweep-empty"),
                        "nodes": (mv[members].astype(np.int64) * S
                                  + ms[members]),
                        "line_idx": int(line_idx[c])})

            return [FinalLine3D(seg_rows[kbounds[c]: kbounds[c + 1]],
                                res_all[order[bounds[c]: bounds[c + 1]]])
                    for c in np.flatnonzero(emit)]

    # ------------------------------------------------------------------
    def _split_bimodal_clusters(self, mc, mv, ms, C, lineP1, line_dir,
                                estP1, estP2, st, visibility, gap_t,
                                max_depth: int = 2, m_score=None,
                                strong_min: float = 0.0):
        """Split clusters whose members are bimodal in signed perpendicular
        offset from the fitted 3D line (in sigma = k * depth units, the
        affinity's pixel-equivalent scale).

        Close parallel structure lines (median separation ~3.8 px on the
        golden testdata) merge when triangulation noise smears the best
        hypotheses toward each other; the merged cluster's members still
        carry the side information in their perpendicular offsets.  A
        cluster is split at the largest inter-member gap when that gap is
        >= ``gap_t`` sigma and BOTH sides retain >= ``visibility`` distinct
        cameras (a failed side would be dropped by the reference's
        visibility filter anyway, so we keep the cluster whole instead).
        No reference counterpart: this compensates estimate-noise relative
        to the reference (tools/diag_smear_cases.py), not a new feature.

        ``strong_min`` > 0 restricts the split DECISION (principal axis,
        Otsu gates, visibility) to members whose best match score is at
        least that value — score ~ number of confirming cameras, so 3.0
        means 3-camera-confirmed estimates.  Merged bundles carry a fog of
        1-2-camera members with large depth errors (tools/
        diag_bridge_classes.py) that previously dominated the PCA axis and
        masked the lateral core separation; strong members expose it.
        Weak members are then assigned to the nearer mode.

        Host numpy, as in the JAX package (``numpy.linalg.eigh`` on the
        same float64 inputs: the principal axis's free sign only swaps
        which side keeps the old cluster id).  ``st`` holds ``cb`` (the
        CameraBatch) and ``median_depth`` (numpy).

        Each candidate whose mode separation ``delta`` reaches 0.5 sigma is
        recorded in ``self._split_records`` when that is a list (``delta``,
        Ashman's ``D``, the size ``n``, the depth ``lvl``, the two sides'
        (views, segments) ``lo`` and ``hi``, and ``applied``); the
        environment variable ``L3D_SPLIT_DEBUG`` prints the counts of the
        gates that stopped a split and of the splits, once a call.
        """
        k_reg = np.asarray(st["cb"].k_reg)
        cam_C = np.asarray(st["cb"].C)
        med_d = np.asarray(st["median_depth"])

        pm = 0.5 * (estP1[mv, ms] + estP2[mv, ms])         # (m, 3) midpoints
        depth = np.linalg.norm(pm - cam_C[mv], axis=1)
        sigma = np.maximum(k_reg[mv] * np.minimum(depth, med_d[mv]), EPS)

        order = np.argsort(mc, kind="stable")
        bounds = np.searchsorted(mc[order], np.arange(C + 1))

        new_mc = mc.copy()
        lineP2 = lineP1 + 2.0 * line_dir       # fit convention: cog +- dir
        next_id = C
        dbg = {"small": 0, "delta": 0, "ashman": 0, "vis": 0, "split": 0}
        stack = [(c, order[bounds[c]: bounds[c + 1]], 0) for c in range(C)]
        while stack:
            c, idx, depth_lvl = stack.pop()
            if len(idx) < 4 or depth_lvl >= max_depth:
                dbg["small"] += depth_lvl == 0
                continue
            if strong_min > 0 and m_score is not None:
                strong = idx[m_score[idx] >= strong_min]
                if len(strong) < 4:
                    dbg["small"] += depth_lvl == 0
                    continue
            else:
                strong = idx
            d = line_dir[c]
            w = pm[strong] - lineP1[c]
            perp = w - (w @ d)[:, None] * d[None, :]
            # principal perpendicular axis of the (strong) offsets
            cov = perp.T @ perp
            _, vecs = np.linalg.eigh(cov)
            u = vecs[:, -1]
            w_all = pm[idx] - lineP1[c]
            perp_all = w_all - (w_all @ d)[:, None] * d[None, :]
            s_all = (perp_all @ u) / sigma[idx]
            s = (perp @ u) / sigma[strong]
            o2 = np.argsort(s)
            ss = s[o2]
            n = len(ss)
            # Otsu-style 2-means: split maximizing between-class variance;
            # accept when the mode-mean separation >= gap_t sigma (a
            # unimodal Gaussian yields ~1.6 std < gap_t, so pure noise
            # does not split)
            csum = np.cumsum(ss)
            csq = np.cumsum(ss * ss)
            kk = np.arange(1, n)
            mean_lo = csum[:-1] / kk
            mean_hi = (csum[-1] - csum[:-1]) / (n - kk)
            delta = mean_hi - mean_lo
            bcv = kk * (n - kk) * delta * delta
            g = int(np.argmax(bcv))
            split_t = 0.5 * (mean_lo[g] + mean_hi[g])
            if strong_min > 0 and m_score is not None:
                # assign ALL members (incl. weak) by the strong-mode midpoint
                lo_all = idx[s_all <= split_t]
                hi_all = idx[s_all > split_t]
            else:
                # legacy mode (no strong gating): rank split at the Otsu cut
                # so every member lands on its own side — the midpoint can
                # fall outside (ss[g], ss[g+1]) for asymmetric modes and
                # would silently reassign members vs the round-2 tuning
                lo_all = strong[o2[: g + 1]]
                hi_all = strong[o2[g + 1:]]
            # within-mode variances; cancellation can drive them a hair
            # negative for near-identical offsets: clamp so D stays finite
            # (NaN would silently pass the gate)
            var_lo = max(csq[g] / (g + 1) - mean_lo[g] ** 2, 0.0)
            var_hi = max((csq[-1] - csq[g]) / (n - g - 1)
                         - mean_hi[g] ** 2, 0.0)
            D = delta[g] / max(np.sqrt(0.5 * (var_lo + var_hi)), EPS)
            rec = None
            if self._split_records is not None and delta[g] >= 0.5:
                rec = {"delta": float(delta[g]), "D": float(D), "n": n,
                       "lvl": depth_lvl,
                       "lo": (mv[lo_all].copy(), ms[lo_all].copy()),
                       "hi": (mv[hi_all].copy(), ms[hi_all].copy()),
                       "applied": False}
                self._split_records.append(rec)
            if delta[g] < gap_t:
                dbg["delta"] += 1
                continue
            # Ashman's D: the modes must also be separated relative to
            # their within-mode spread (D >= 2 ~ clean bimodality); a
            # smeared unimodal cluster can reach delta ~1.6 std but its
            # within-mode variance stays high, failing this gate
            if D < 2.0:
                dbg["ashman"] += 1
                continue
            lo, hi = lo_all, hi_all
            # visibility gate on STRONG members per side when gating is on:
            # a mode is only real if >= visibility cameras confirm it well
            vis_lo = strong[s <= split_t] if strong_min > 0 else lo
            vis_hi = strong[s > split_t] if strong_min > 0 else hi
            if (len(np.unique(mv[vis_lo])) < visibility
                    or len(np.unique(mv[vis_hi])) < visibility
                    or not len(lo) or not len(hi)):
                dbg["vis"] += 1
                continue
            dbg["split"] += 1
            if rec is not None:
                rec["applied"] = True
            # split: high side becomes a new cluster; refit both
            new_mc[hi] = next_id
            for part in (lo, hi):
                pts_p = np.concatenate([estP1[mv[part], ms[part]],
                                        estP2[mv[part], ms[part]]], axis=0)
                lf = fitting_ops.fit_lines_np(
                    pts_p, np.zeros(len(pts_p), np.int32), 1)
                P1p, P2p = np.asarray(lf.P1)[0], np.asarray(lf.P2)[0]
                dp = P2p - P1p
                dp /= max(np.linalg.norm(dp), EPS)
                cid = c if part is lo else next_id
                if cid == next_id:
                    lineP1 = np.concatenate([lineP1, P1p[None]], axis=0)
                    lineP2 = np.concatenate([lineP2, P2p[None]], axis=0)
                    line_dir = np.concatenate([line_dir, dp[None]], axis=0)
                else:
                    lineP1[cid] = P1p
                    lineP2[cid] = P2p
                    line_dir[cid] = dp
                stack.append((cid, part, depth_lvl + 1))
            next_id += 1

        if os.environ.get("L3D_SPLIT_DEBUG"):
            print(f"[L3D-TPU] bimodal split: {dbg}", flush=True)
        return new_mc, next_id, lineP1, lineP2, line_dir

    # ------------------------------------------------------------------
    def _visual_neighbors(self, cam_ids, cams, N) -> dict[int, list[int]]:
        """Worldpoint-overlap neighbor selection with baseline-diversity
        re-ranking (reference: findVisualNeighborsFromWPs line3D.cc:578-699),
        nearest camera centres when views carry no worldpoints, or fixed
        lists when provided (line3D.cc:230-246).  Ties in the score sort
        break by ascending target index."""
        out: dict[int, list[int]] = {}
        V = len(cam_ids)
        have_wps = all(self._views[c].worldpoints is not None
                       for c in cam_ids)
        todo = [i for i, c in enumerate(cam_ids)
                if c not in self._fixed_neighbors]
        for c in cam_ids:
            if c in self._fixed_neighbors:
                out[c] = [n for n in self._fixed_neighbors[c]
                          if n in self._views]
        if not todo:
            return out

        C = np.stack([cam.C for cam in cams])                    # (V, 3)

        if not have_wps:
            # geometric fallback: nearest cameras by center distance
            # (chunked so the distance matrix never exceeds ~chunk*V)
            todo_set = set(todo)
            for start in range(0, V, 512):
                idx = np.arange(start, min(start + 512, V))
                d = np.linalg.norm(C[idx, None, :] - C[None, :, :], axis=2)
                d[np.arange(len(idx)), idx] = np.inf
                order = np.argsort(d, axis=1, kind="stable")[:, :N]
                for r, i in enumerate(idx):
                    if i in todo_set:
                        out[cam_ids[i]] = [cam_ids[j] for j in order[r]
                                           if np.isfinite(d[r, j])]
            return out

        # ---- worldpoint-overlap counts: one sparse matmul ----
        import scipy.sparse as sp

        wp_index: dict = {}
        rows, cols = [], []
        for i, c in enumerate(cam_ids):
            for wp in self._views[c].worldpoints:
                cols.append(wp_index.setdefault(wp, len(wp_index)))
                rows.append(i)
        nwp = np.array([len(self._views[c].worldpoints) for c in cam_ids],
                       np.float64)
        A = sp.csr_matrix(
            (np.ones(len(rows), np.int64), (rows, cols)),
            shape=(V, max(len(wp_index), 1)))
        common = sp.triu(A @ A.T, k=1).tocoo()   # symmetric; keep i < j once
        i_ = np.concatenate([common.row, common.col])
        j_ = np.concatenate([common.col, common.row])
        n_ = np.concatenate([common.data, common.data]).astype(np.float64)

        # ---- batched candidate filters/scores (line3D.cc:620-636) ----
        axes = np.stack([cam.optical_axis() for cam in cams])    # (V, 3)
        R = np.stack([cam.R for cam in cams])
        t = np.stack([cam.t for cam in cams])
        dot = np.clip(np.sum(axes[i_] * axes[j_], axis=1), -1.0, 1.0)
        keep = (np.arccos(dot) < 1.571) & (n_ > 4)
        i_, j_, n_ = i_[keep], j_[keep], n_[keep]

        score = 2.0 * n_ / (nwp[i_] + nwp[j_])
        Ct = np.einsum("pab,pb->pa", R[i_], C[j_]) + t[i_]
        dist_score = np.abs(Ct[:, 0]) + np.abs(Ct[:, 1])
        baseline_ok = np.linalg.norm(C[i_] - C[j_], axis=1) > 0.1

        # sort all candidates by (row, -score, target) and slice per row
        order = np.lexsort((j_, -score, i_))
        i_, j_ = i_[order], j_[order]
        score, dist_score = score[order], dist_score[order]
        baseline_ok = baseline_ok[order]
        starts = np.searchsorted(i_, np.arange(V + 1))

        # ---- per-view top-N with baseline-diversity rerank ----
        for ci in todo:
            lo, hi = starts[ci], starts[ci + 1]
            cand = list(zip(score[lo:hi], dist_score[lo:hi],
                            j_[lo:hi], baseline_ok[lo:hi]))
            if len(cand) > N:
                score_t = 0.80 * cand[0][0]
                big = [x for x in cand if x[0] > score_t]
                big.sort(key=lambda x: -x[1])
                merged = big[: N // 2] + cand
            else:
                merged = cand
            used: list[int] = []
            for _, _, vj, bok in merged:
                if len(used) >= N:
                    break
                v2_id = cam_ids[vj]
                if v2_id not in used and bok:
                    used.append(v2_id)
            out[cam_ids[ci]] = used
        return out

    # ------------------------------------------------------------------
    # output writers (reference: line3D.cc:2465-2711)
    # ------------------------------------------------------------------
    def save_txt(self, path: str) -> None:
        save_txt(path, self.lines3d)

    def save_stl(self, path: str) -> None:
        save_stl(path, self.lines3d)

    def save_obj(self, path: str) -> None:
        save_obj(path, self.lines3d)

    def save_bin(self, path: str, fmt: str = "boost") -> None:
        """Save the final model as ``.bin``: ``fmt="boost"`` (default) the
        reference's boost binary archive of ``std::vector<FinalLine3D>``
        (save3DLinesAsBIN line3D.cc:2690-2711), which Line3D++ tooling
        reads; ``fmt="npz"`` the compressed numpy archive, which also
        keeps the residuals' 2D endpoints (the boost format has none)."""
        if fmt == "boost":
            ref_bin.save_bin_boost(path, self.lines3d)
        elif fmt == "npz":
            save_bin(path, self.lines3d)
        else:
            raise ValueError(f"unknown bin format {fmt!r}")
