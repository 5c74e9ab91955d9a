"""1D interval sweep: collinear 3D sub-segment extraction per cluster.

Each cluster member's 2D segment projects onto the cluster's 3D line as an
interval [s1, s2]; sweeping the interval endpoints from the border inward
emits 3D sub-segments wherever >= `visibility` *distinct cameras* have an open
interval (reference: findCollinearSegments(cluster) line3D.cc:2342-2452).

:func:`sweep_all_flat` is a copy of ``line3dpp_tpu.ops.sweep.sweep_all_flat``:
host numpy, vectorized over the events of every cluster.  The pipeline's
stage, :func:`sweep_clusters`, projects the members onto their lines, sweeps
and picks each cluster's reference view: on CUDA tensors in one kernel,
``csrc/sweep.cu`` (:func:`sweep_clusters_cuda`: a warp per cluster over the
members in cluster order, one upload, one launch, one readback), on CPU
tensors by :func:`sweep_clusters_plain`, the numpy functions
(``fitting.project_members_onto_lines_np``, :func:`sweep_all_flat`,
:func:`reference_views_np`).  Both give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from . import fitting, kernels

# members a cluster may have for the kernel to keep it in its warp's slice
# of shared memory (csrc/sweep.cu kCap); a longer cluster takes the global
# scratch, SCRATCH_BYTES a member of the whole input
SMEM_MEMBERS = 128
SCRATCH_BYTES = 77


def sweep_all_flat(
    member_cluster: np.ndarray,   # (N,) cluster index per member
    s1: np.ndarray,               # (N,)
    s2: np.ndarray,               # (N,)
    member_ok: np.ndarray,        # (N,) projection validity
    cams: np.ndarray,             # (N,)
    num_clusters: int,
    visibility: int = 3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sweep every cluster at once, fully vectorized; flat-array output.

    Per cluster, interval endpoints are ordered by distance to the border
    point (the endpoint farthest from the cluster COG); the distinct-open-
    camera count rises by one when a camera's open-interval count goes
    0 -> 1 and falls on 1 -> 0; sub-segments are emitted while the count is
    >= ``visibility``.

    Returns (cluster_id, s_start, s_end) arrays — one row per emitted
    interval, grouped by ascending cluster — so the downstream assembly
    (pipeline reconstruct tail) stays array-shaped with no per-cluster
    Python loop (the reference's OpenMP'd computeFinal3Dsegments,
    line3D.cc:2278-2299).
    """
    empty = (np.zeros(0, np.int64), np.zeros(0, float), np.zeros(0, float))
    keep = np.asarray(member_ok, bool)
    if not keep.any():
        return empty
    mc = np.asarray(member_cluster)[keep]
    a = np.asarray(s1, np.float64)[keep]
    b = np.asarray(s2, np.float64)[keep]
    cam = np.asarray(cams)[keep]

    # clusters need >= 3 members (6 endpoints, line3D.cc:2396)
    counts = np.bincount(mc, minlength=num_clusters)
    ok_cluster = counts >= 3
    sel = ok_cluster[mc]
    if not sel.any():
        return empty
    mc, a, b, cam = mc[sel], a[sel], b[sel], cam[sel]
    m = len(mc)

    # border per cluster: projected endpoint farthest from the COG param
    # (s_cog = 1.0 by construction, line3D.cc:2373-2391)
    params = np.concatenate([a, b])                       # (2m,)
    ev_cluster = np.concatenate([mc, mc])
    ev_line = np.tile(np.arange(m), 2)
    ev_cam = np.concatenate([cam, cam])

    absdev = np.abs(params - 1.0)
    border = np.full(num_clusters, 0.0)
    # argmax |param-1| per cluster
    order0 = np.lexsort((absdev, ev_cluster))
    last_of = np.searchsorted(ev_cluster[order0],
                              np.arange(num_clusters + 1))[1:] - 1
    has = counts >= 3
    border[has] = params[order0[last_of[has]]]

    dist = np.abs(params - border[ev_cluster])

    # event order: by cluster, then distance-to-border (stable)
    order = np.lexsort((np.arange(2 * m), dist, ev_cluster))
    ec = ev_cluster[order]
    el = ev_line[order]
    ecam = ev_cam[order]
    epos = params[order]

    # open/close: the first event of each (cluster, line) pair IN SWEEP
    # ORDER opens (el/ec are already sweep-ordered, so the position key is
    # just arange)
    o2 = np.lexsort((np.arange(2 * m), el, ec))
    sign_sorted = np.empty(2 * m, np.int64)
    sign_sorted[0::2] = 1          # groups of exactly 2 events per line
    sign_sorted[1::2] = -1
    sign = np.empty(2 * m, np.int64)
    sign[o2] = sign_sorted

    # per (cluster, cam) running count -> distinct-camera deltas
    o3 = np.lexsort((np.arange(2 * m), ecam, ec))
    s3 = sign[o3]
    grp = np.flatnonzero(np.diff(ecam[o3], prepend=-9) |
                         np.diff(ec[o3], prepend=-9))
    run = np.cumsum(s3)
    base = np.zeros(2 * m, np.int64)
    base[grp] = np.concatenate([[0], run[grp[1:] - 1]])
    base = np.maximum.accumulate(base)
    cnt = run - base                                     # count after event
    delta3 = np.where((s3 > 0) & (cnt == 1), 1,
                      np.where((s3 < 0) & (cnt == 0), -1, 0))
    delta = np.empty(2 * m, np.int64)
    delta[o3] = delta3

    # distinct-open-cameras after each event, per cluster: global cumsum
    # minus the cumulative value just before the cluster's first event
    runall = np.cumsum(delta)
    cgrp = np.flatnonzero(np.diff(ec, prepend=-9))
    start_cum = np.concatenate([[0], runall])[cgrp]
    opencnt = runall - np.repeat(start_cum,
                                 np.diff(np.append(cgrp, 2 * m)))

    above = opencnt >= visibility
    prev = np.concatenate([[False], above[:-1]])
    prev[cgrp] = False
    starts = np.flatnonzero(above & ~prev)
    # an interval closes at the first event where `above` drops
    ends_mask = ~above & prev
    ends = np.flatnonzero(ends_mask)

    # starts/ends alternate within each cluster and sweep order is grouped
    # by cluster, so positional pairing is exact
    return (ec[starts].astype(np.int64),
            epos[starts].astype(float), epos[ends].astype(float))


def cluster_csr(member_cluster: np.ndarray, num_clusters: int):
    """The members in cluster order: a stable argsort ``order`` of the
    member clusters (each cluster's members keep their order) and the
    ``bounds`` (C + 1,) of each cluster's members in it.  The sort key is
    (cluster, member index), unique, so numpy's quicksort gives the stable
    order (4x faster than its stable sort on ~16,000 members)."""
    mc = np.asarray(member_cluster, np.int64)
    order = np.argsort(mc * len(mc) + np.arange(len(mc)))
    bounds = np.zeros(num_clusters + 1, np.int64)
    np.cumsum(np.bincount(mc, minlength=num_clusters), out=bounds[1:])
    return order, bounds


def reference_views_np(segs: np.ndarray, mc, mv, ms,
                       num_clusters: int) -> np.ndarray:
    """Each cluster's reference view: the camera of its longest member 2D
    segment (``segs`` (V, S, 4) float32), the first member winning ties
    (line3D.cc:2183-2189); 0 for a cluster without members."""
    lens2d = np.hypot(segs[mv, ms, 2] - segs[mv, ms, 0],
                      segs[mv, ms, 3] - segs[mv, ms, 1])
    ref_view = np.zeros(num_clusters, np.int32)
    o_rv = np.lexsort((-np.arange(len(mc)), lens2d, mc))
    ref_view[mc[o_rv]] = mv[o_rv]  # last write per cluster = argmax
    return ref_view


def sweep_clusters(r1, r2, segs, cam_C, line_P1, line_dir, mc, mv, ms,
                   num_clusters: int, visibility: int, csr=None,
                   stats: dict | None = None):
    """The sweep stage of the reconstruction: every member's segment
    projected onto its cluster's line (line3D.cc:2221-2266), the intervals
    swept over distinct open cameras (line3D.cc:2342-2452) and each
    cluster's reference view.

    ``r1``, ``r2`` (V, S, 3) are the segments' endpoint rays and ``segs``
    (V, S, 4) the segments, float32 tensors on one device; ``cam_C`` (V, 3)
    the camera centres, ``line_P1`` and ``line_dir`` (C, 3) the lines, and
    ``mc``, ``mv``, ``ms`` (m,) each member's cluster, view and segment,
    host arrays; ``csr``, where given, is :func:`cluster_csr` of ``mc``.
    Returns ``(iv_c, iv_sa, iv_sb, ref_view)``: :func:`sweep_all_flat`'s
    intervals (int64 clusters, float64 parameters, grouped by ascending
    cluster in sweep order) and the (C,) int32 reference views.  On CUDA
    tensors the kernel runs (:func:`sweep_clusters_cuda`), on CPU tensors
    the numpy path (:func:`sweep_clusters_plain`).  ``stats``, where given,
    receives ``clusters``, ``members``, ``intervals`` and
    ``large_clusters`` (the clusters past ``SMEM_MEMBERS`` members that
    took the kernel's global scratch; 0 on the CPU)."""
    fn = (sweep_clusters_cuda if r1.device.type == "cuda"
          else sweep_clusters_plain)
    iv_c, iv_sa, iv_sb, ref_view, large = fn(
        r1, r2, segs, cam_C, line_P1, line_dir, mc, mv, ms, num_clusters,
        visibility, csr)
    if stats is not None:
        stats.update(clusters=int(num_clusters), members=len(mc),
                     intervals=len(iv_c), large_clusters=large)
    return iv_c, iv_sa, iv_sb, ref_view


def sweep_clusters_plain(r1, r2, segs, cam_C, line_P1, line_dir, mc, mv, ms,
                         num_clusters: int, visibility: int, csr=None):
    """:func:`sweep_clusters` by the numpy functions on the host (``csr``
    is not needed); the fifth value is 0, the clusters that took a global
    scratch."""
    r1 = r1.cpu().numpy()
    r2 = r2.cpu().numpy()
    s1, s2, ok = fitting.project_members_onto_lines_np(
        line_P1[mc], line_dir[mc], cam_C[mv], r1[mv, ms], r2[mv, ms])
    iv_c, iv_sa, iv_sb = sweep_all_flat(mc, s1, s2, ok, mv, num_clusters,
                                        visibility)
    ref_view = reference_views_np(segs.cpu().numpy(), mc, mv, ms,
                                  num_clusters)
    return iv_c, iv_sa, iv_sb, ref_view, 0


def _check_arguments(r1, r2, segs, cam_C, line_P1, line_dir, mc, mv, ms,
                     num_clusters: int, visibility: int, csr) -> None:
    """Raise unless the arguments are what the kernel takes: float32
    contiguous rays and segments on one CUDA device, host arrays of the
    shapes they give, member ids in range, ``visibility`` >= 1 and a CSR
    of ``mc``'s length."""
    if r1.dim() != 3 or r1.shape[2] != 3:
        raise ValueError(f"r1: shape {tuple(r1.shape)}, expected (V, S, 3)")
    V, S = r1.shape[:2]
    dev, f32 = r1.device, torch.float32
    for name, x, shape in (("r1", r1, (V, S, 3)), ("r2", r2, (V, S, 3)),
                           ("segs", segs, (V, S, 4))):
        kernels.check(name, x, f32, shape, dev)
    C = int(num_clusters)
    for name, x, shape in (("cam_C", cam_C, (V, 3)),
                           ("line_P1", line_P1, (C, 3)),
                           ("line_dir", line_dir, (C, 3))):
        if np.shape(x) != shape:
            raise ValueError(f"{name}: shape {np.shape(x)}, expected "
                             f"{shape}")
    m = len(mc)
    for name, x, hi in (("mc", mc, C), ("mv", mv, V), ("ms", ms, S)):
        x = np.asarray(x)
        if x.shape != (m,) or x.dtype.kind not in "iu":
            raise ValueError(f"{name}: {x.dtype} of shape {x.shape}, "
                             f"expected integers of shape ({m},)")
        if m and (x.min() < 0 or x.max() >= hi):
            raise ValueError(f"{name}: ids outside [0, {hi})")
    if visibility < 1:
        raise ValueError(f"visibility {visibility}: the sweep needs >= 1")
    if m >= 2**31:
        raise ValueError(f"{m} members: the kernel takes fewer than 2^31")
    if csr is not None and (len(csr[0]) != m or len(csr[1]) != C + 1):
        raise ValueError("csr: not the cluster order of mc")


def _pack(arrays) -> tuple[np.ndarray, list[int]]:
    """The arrays' bytes in one host buffer, each at a multiple of 8, and
    their offsets."""
    offsets, size = [], 0
    for a in arrays:
        offsets.append(size)
        size += -(-a.nbytes // 8) * 8
    buf = np.zeros(size, np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf, offsets


def compact_intervals(sa, sb, n_iv, bounds):
    """The kernel's intervals, written at each cluster's CSR offset
    (``bounds``) with their counts ``n_iv``, as :func:`sweep_all_flat`'s
    flat arrays."""
    C = len(n_iv)
    iv_c = np.repeat(np.arange(C, dtype=np.int64), n_iv)
    first = np.cumsum(n_iv, dtype=np.int64) - n_iv
    pos = (np.asarray(bounds[:-1], np.int64)[iv_c]
           + np.arange(len(iv_c)) - first[iv_c])
    return iv_c, sa[pos], sb[pos]


def sweep_clusters_cuda(r1, r2, segs, cam_C, line_P1, line_dir, mc, mv, ms,
                        num_clusters: int, visibility: int, csr=None):
    """:func:`sweep_clusters` by the kernel ``csrc/sweep.cu``: the members'
    views and segments in cluster order, the CSR bounds, the lines in
    float64 and the camera centres uploaded in one copy, one launch (a warp
    a cluster), one read of the intervals at each cluster's offset, their
    counts and the reference views, compacted on the host
    (:func:`compact_intervals`).  The fifth value is the number of
    clusters past ``SMEM_MEMBERS`` members, which take the kernel's global
    scratch.  Counted once a call as ``sweep``."""
    _check_arguments(r1, r2, segs, cam_C, line_P1, line_dir, mc, mv, ms,
                     num_clusters, visibility, csr)
    C, m = int(num_clusters), len(mc)
    _, S = r1.shape[:2]
    empty = (np.zeros(0, np.int64), np.zeros(0, float), np.zeros(0, float))
    if C == 0 or m == 0:
        return (*empty, np.zeros(C, np.int32), 0)
    order, bounds = csr if csr is not None else cluster_csr(mc, C)
    bounds = np.asarray(bounds, np.int32)
    large = int((np.diff(bounds) > SMEM_MEMBERS).sum())
    host, offsets = _pack([
        np.ascontiguousarray(line_P1, np.float64),
        np.ascontiguousarray(line_dir, np.float64),
        np.ascontiguousarray(cam_C, np.float32),
        np.asarray(mv, np.int32)[order], np.asarray(ms, np.int32)[order],
        bounds])
    dev = r1.device
    inp = torch.from_numpy(host).to(dev)
    out = torch.empty(16 * m + 8 * C, dtype=torch.uint8, device=dev)
    scratch = (torch.empty(SCRATCH_BYTES * m, dtype=torch.uint8, device=dev)
               if large else None)
    at = lambda t, o: kernels.ptr(t[o:])              # noqa: E731
    P1, D, cams, views, seg_ids, csr_b = (at(inp, o) for o in offsets)
    kernels.launch("l3d_sweep", kernels.ptr(r1), kernels.ptr(r2),
                   kernels.ptr(segs), cams, P1, D, views, seg_ids, csr_b,
                   C, m, S, int(visibility),
                   kernels.ptr(scratch) if large else None,
                   at(out, 0), at(out, 8 * m), at(out, 16 * m),
                   at(out, 16 * m + 4 * C), kernels.stream(dev))
    obs.launched("sweep")
    got = out.cpu().numpy()
    sa = got[:8 * m].view(np.float64)
    sb = got[8 * m:16 * m].view(np.float64)
    n_iv = got[16 * m:16 * m + 4 * C].view(np.int32)
    ref_view = got[16 * m + 4 * C:].view(np.int32).copy()
    return (*compact_intervals(sa, sb, n_iv, bounds), ref_view, large)
