"""Line3D pipeline orchestrator (PyTorch port).

The counterpart of ``line3dpp_tpu.models.pipeline.Line3D`` and of the
reference's ``L3DPP::Line3D`` class (reference: line3D.h:61-424): owns views,
runs

    [1] view ingestion  ->  [2] line matching  ->  [3] reconstruction

and writes the resulting 3D line model.  Phase 2 is one fused device step
(``models/step.py``) on ``self.device``; phase 3 is host numpy.

The port covers the default reconstruction from images (LSD detection,
``add_image``/``add_images``) or from precomputed segments (``add_view``).
Options it does not run raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..camera import (Camera, CameraBatch, fundamental_matrices,
                      median_center_translation)
from ..config import Config
from ..ops import affinity as affinity_ops
from ..ops import clustering as clustering_ops
from ..ops import fitting as fitting_ops
from ..ops import geometry as geo
from ..ops import lsd as lsd_ops
from ..ops import sweep as sweep_ops
from ..utils import segments_cache
from ..utils.writers import FinalLine3D, save_obj, save_stl, save_txt
from .step import forward_step

EPS = 1e-12
# the array arguments of models.step.forward_step, in order
STEP_ARRAYS = ("segments", "seg_mask", "RtKinv", "C", "k_reg",
               "neighbor_ids", "F", "pair_valid")


def _check_supported(cfg: Config) -> None:
    """Raise for configuration options this slice of the port does not run."""
    todo = [
        (cfg.optimize, "optimize=True (line bundling)", 8),
        (cfg.perform_rdd, "perform_rdd=True", 13),
        (cfg.collinearity_t > 0, "collinearity_t > 0", 13),
        (cfg.split_bimodal_t > 0, "split_bimodal_t > 0", 13),
        (cfg.cluster_strong_min > 0, "cluster_strong_min > 0", 13),
        (cfg.match_rel_cut > 0, "match_rel_cut > 0", 13),
        (cfg.view_block > 0, "view_block > 0 (blocked matching)", 14),
        (cfg.knn <= 0, "knn <= 0 (keep all matches, blocked matching)", 14),
    ]
    for on, what, item in todo:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to line3dpp_tpu_torch yet (ROADMAP "
                f"item {item}); pass Config(optimize=False) with the "
                f"defaults of the other options")


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
        _check_supported(self.config)
        self._views: dict[int, _ViewEntry] = {}
        self._fixed_neighbors: dict[int, list[int]] = {}
        self.lines3d: list[FinalLine3D] = []
        self._last_state: dict = {}

    # ------------------------------------------------------------------
    # phase 1: view ingestion (reference: addImage line3D.cc:112-227)
    # ------------------------------------------------------------------
    def add_view(self, cam_id: int, camera: Camera, segments: np.ndarray,
                 worldpoints: Sequence[int] | None = None) -> None:
        """Register a view with precomputed 2D segments (the
        ``line_segments`` path of addImage, reference: line3D.h:104-108)."""
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
        instead of detected, and new detections are stored."""
        cfg = self.config
        if cfg.lsd_rescue or cfg.lsd_seed_gate:
            raise NotImplementedError(
                "Config(lsd_rescue=True) and Config(lsd_seed_gate=True) are "
                "not ported to line3dpp_tpu_torch yet (ROADMAP item 13)")
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
            n_rounds=cfg.lsd_rounds, device=self.device)
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

        # the [V, S, N*k] match tensors of the fused step; the JAX package
        # switches to blocked matching above 2 GiB per array
        fused_bytes = V * S * N * k * 4
        if fused_bytes > (2 << 30):
            raise NotImplementedError(
                f"match tensors of {fused_bytes / (1 << 30):.1f} GiB per "
                f"array need blocked matching, which is not ported to "
                f"line3dpp_tpu_torch yet (ROADMAP item 14)")
        return dict(segments=segs, seg_mask=mask, RtKinv=cb.RtKinv, C=cb.C,
                    k_reg=cb.k_reg, neighbor_ids=neighbor_ids, F=F,
                    pair_valid=pair_valid, cam_ids=cam_ids, cams=cams,
                    translation=translation, cb=cb, knn=k)

    def match_images(self) -> None:
        cfg = self.config
        inp = self.step_inputs()
        dev = self.device
        arrays = {n: torch.from_numpy(inp[n]).to(dev) for n in STEP_ARRAYS}
        out = forward_step(
            **arrays, epipolar_overlap=cfg.epipolar_overlap, knn=inp["knn"],
            two_sig_a_sqr=cfg.two_sig_a_sqr,
            min_similarity=cfg.min_similarity_3d,
            check_orientation=cfg.check_match_orientation,
            min_best_score=cfg.min_best_score_3d,
            min_best_score_perc=cfg.min_best_score_perc,
            min_affinity=cfg.min_affinity,
            pair_chunk=max(cfg.pair_chunk, 1))
        r1, r2 = geo.segment_rays(arrays["RtKinv"][:, None],
                                  arrays["segments"])

        self._last_state = dict(
            cam_ids=inp["cam_ids"], cams=inp["cams"],
            translation=inp["translation"], cb=inp["cb"],
            segs=inp["segments"], mask=inp["seg_mask"],
            neighbor_ids=inp["neighbor_ids"], knn=inp["knn"],
            r1=r1, r2=r2, out=out)

    # ------------------------------------------------------------------
    # phase 3: clustering, line fit, sweep (host)
    # ------------------------------------------------------------------
    def reconstruct_3d_lines(self) -> list[FinalLine3D]:
        cfg = self.config
        st = self._last_state
        if not st:
            raise RuntimeError("call match_images() first")
        cam_ids, cb, out = st["cam_ids"], st["cb"], st["out"]
        V, S = st["mask"].shape
        M = out.tgt_seg.shape[2]
        visibility = max(cfg.visibility_t, 3)

        # --- edge extraction: device-side compaction, then host dedup
        # (line3D.cc:1881-1899).  Only O(E) values cross to the host.
        idx, ww, ts_e = affinity_ops.compact_edges(
            affinity_ops.AffinityDense(out.aff_weight, out.aff_valid),
            out.tgt_seg)
        src_v = idx // (S * M)
        src_s = (idx // M) % S
        tv_e = st["neighbor_ids"][src_v, (idx % M) // st["knn"]]
        gid_a = src_v * S + src_s
        gid_b = tv_e.astype(np.int64) * S + ts_e

        lo = np.minimum(gid_a, gid_b)
        hi = np.maximum(gid_a, gid_b)
        _, first = np.unique(lo * (V * S) + hi, return_index=True)
        lo, hi, ww = lo[first], hi[first], ww[first]

        if len(ww) == 0:
            self.lines3d = []
            return self.lines3d

        # local node ids for nodes that appear in edges
        nodes, inv = np.unique(np.concatenate([lo, hi]), return_inverse=True)
        li = inv[: len(lo)].astype(np.int32)
        lj = inv[len(lo):].astype(np.int32)

        # both directions, as the reference pushes symmetric entries
        ei = np.concatenate([li, lj])
        ej = np.concatenate([lj, li])
        ew = np.concatenate([ww, ww]).astype(np.float32)
        labels = clustering_ops.cluster_edges(ei, ej, ew, len(nodes),
                                              cfg.felzenszwalb_c)

        # --- group nodes into clusters with >= visibility distinct cameras
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
        if C == 0:
            self.lines3d = []
            return self.lines3d

        # --- line fit from member hypothesis endpoints
        estP1 = out.est_P1.cpu().numpy()
        estP2 = out.est_P2.cpu().numpy()
        pts = np.concatenate([estP1[mv, ms], estP2[mv, ms]], axis=0)
        lines = fitting_ops.fit_lines_np(pts, np.concatenate([mc, mc]), C)
        lineP1 = lines.P1
        line_dir = lines.P2 - lines.P1
        line_dir /= np.maximum(
            np.linalg.norm(line_dir, axis=-1, keepdims=True), EPS)

        # --- project member segments onto their cluster lines
        r1 = st["r1"].cpu().numpy()
        r2 = st["r2"].cpu().numpy()
        s1, s2, ok = fitting_ops.project_members_onto_lines_np(
            lineP1[mc], line_dir[mc], cb.C[mv], r1[mv, ms], r2[mv, ms])

        # --- interval sweep (line3D.cc:2342-2452), flat arrays
        iv_c, iv_sa, iv_sb = sweep_ops.sweep_all_flat(
            mc, s1, s2, ok, mv, C, visibility)

        # reference view per cluster = camera of longest member 2D segment
        # (line3D.cc:2183-2189); the first member wins ties
        seg2d = st["segs"]
        lens2d = np.hypot(seg2d[mv, ms, 2] - seg2d[mv, ms, 0],
                          seg2d[mv, ms, 3] - seg2d[mv, ms, 1])
        ref_view = np.zeros(C, np.int32)
        o_rv = np.lexsort((-np.arange(len(mc)), lens2d, mc))
        ref_view[mc[o_rv]] = mv[o_rv]  # last write per cluster = argmax

        # --- assemble + tiny-segment filter (line3D.cc:2302-2339)
        translation = st["translation"]
        cams = st["cams"]
        order = np.argsort(mc, kind="stable")
        bounds = np.searchsorted(mc[order], np.arange(C + 1))

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

        self.lines3d = [
            FinalLine3D(seg_rows[kbounds[c]: kbounds[c + 1]],
                        res_all[order[bounds[c]: bounds[c + 1]]])
            for c in np.flatnonzero(emit)]
        return self.lines3d

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
