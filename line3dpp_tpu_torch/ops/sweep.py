"""1D interval sweep: collinear 3D sub-segment extraction per cluster.

Each cluster member's 2D segment projects onto the cluster's 3D line as an
interval [s1, s2]; sweeping the interval endpoints from the border inward
emits 3D sub-segments wherever >= `visibility` *distinct cameras* have an open
interval (reference: findCollinearSegments(cluster) line3D.cc:2342-2452).

The sweep is irregular and tiny (SURVEY.md §7.1) — it runs on the host over
numpy arrays, vectorized over events within each cluster.  A copy of
``line3dpp_tpu.ops.sweep.sweep_all_flat``.
"""

from __future__ import annotations

import numpy as np


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
