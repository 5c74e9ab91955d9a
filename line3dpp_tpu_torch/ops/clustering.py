"""Graph clustering over the sparse affinity matrix.

Felzenszwalb/Huttenlocher-style union-find with an adaptive per-component
threshold (reference: clustering.cc:6-48, universe.h:49-104; invoked with
c = 3.0 from line3D.cc:2089).  Edges are processed in ascending weight order;
components a, b merge when ``w <= threshold[a] && w <= threshold[b]``, after
which ``threshold[root] = w + c / size``.

The stage is sequential and small, so it runs on the host: the C++ union-find
in ``native/l3dnative.cc`` is built with g++ into ``build/native/`` of the
checkout at first use; where it cannot be built, the python loop runs.
:func:`cluster_edges_anchored` (``Config.cluster_strong_min``) is the JAX
package's two-pass host loop, copied.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "l3dnative.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")


@functools.cache
def _native_lib() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libl3dnative_{tag}.so")
    if not os.path.exists(path):
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
                so = os.path.join(tmp, "lib.so")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                "-std=c++17", _SRC, "-o", so], check=True,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
                os.replace(so, path)
        except (OSError, subprocess.CalledProcessError):
            return None
    lib = ctypes.CDLL(path)
    lib.l3d_cluster.restype = ctypes.c_int
    lib.l3d_cluster.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
    return lib


def cluster_edges(i: np.ndarray, j: np.ndarray, w: np.ndarray,
                  num_nodes: int, c: float = 3.0) -> np.ndarray:
    """Cluster nodes given symmetric sparse edges; returns root label per node.

    Mirrors performClustering (clustering.cc:6-48).  Edge order within equal
    weights follows the input order (std::list::sort is stable).
    """
    i = np.ascontiguousarray(i, dtype=np.int32)
    j = np.ascontiguousarray(j, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)

    order = np.argsort(w, kind="stable")
    i, j, w = i[order], j[order], w[order]

    lib = _native_lib()
    if lib is not None:
        labels = np.empty(num_nodes, dtype=np.int32)
        lib.l3d_cluster(
            i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            j.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(w), num_nodes, c,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return labels
    return cluster_python(i, j, w, num_nodes, c)


def cluster_python(i, j, w, num_nodes: int, c: float) -> np.ndarray:
    """The union-find loop in python, over edges already sorted by weight."""
    parent = np.arange(num_nodes, dtype=np.int64)
    rank = np.zeros(num_nodes, dtype=np.int32)
    size = np.ones(num_nodes, dtype=np.int64)
    threshold = np.full(num_nodes, c, dtype=np.float64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        parent[x] = root      # single-step compression as universe.h:70-78
        return root

    for ii, jj, ww in zip(i.tolist(), j.tolist(), w.tolist()):
        a = find(ii)
        b = find(jj)
        if a == b:
            continue
        if ww <= threshold[a] and ww <= threshold[b]:
            # join by rank (universe.h:82-97)
            if rank[a] > rank[b]:
                parent[b] = a
                size[a] += size[b]
                root = a
            else:
                parent[a] = b
                size[b] += size[a]
                if rank[a] == rank[b]:
                    rank[b] += 1
                root = b
            threshold[root] = ww + c / size[root]

    return np.array([find(x) for x in range(num_nodes)], dtype=np.int32)


def cluster_edges_anchored(
    i: np.ndarray, j: np.ndarray, w: np.ndarray, num_nodes: int,
    strong: np.ndarray, c: float = 3.0,
) -> np.ndarray:
    """Two-tier bridge-resistant clustering (no reference counterpart).

    Pass 1 clusters the subgraph induced by ``strong`` nodes with the
    standard adaptive-threshold rule; pass 2 replays ALL edges with one
    extra constraint: a merge is rejected when it would join components
    anchored to two DIFFERENT strong clusters.  Weak (1-2-camera) nodes can
    therefore join a well-supported structure but never glue two of them
    together — which is exactly how close parallel line bundles merge
    through estimate-noise fog (tools/diag_bridge_classes.py: of 3836
    bridge edges inside merged clusters only 31 connect two confidently
    sided strong nodes).

    NOTE pass 2 does NOT guarantee pass-1 strong clusters survive intact:
    weak members interleaved into pass 2 inflate component sizes, lowering
    the adaptive threshold ``w + c/size``, so a strong-strong merge accepted
    in pass 1 can be rejected in pass 2.  The pass-2 strong components are a
    REFINEMENT of the pass-1 partition (never coarser — the anchor gate
    blocks cross-anchor merges — but possibly finer); the anchor gate never
    fires between fragments of the same pass-1 cluster.  Covered by
    tests/test_clustering.py::test_anchored_pass2_may_refine_pass1.

    ``strong``: bool (num_nodes,).  Returns root label per node.
    """
    i = np.ascontiguousarray(i, dtype=np.int32)
    j = np.ascontiguousarray(j, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)

    ss = strong[i] & strong[j]
    lab1 = cluster_edges(i[ss], j[ss], w[ss], num_nodes, c)
    # anchor = strong-cluster id for strong nodes, -1 for weak ones
    anchor = np.where(strong, lab1.astype(np.int64), -1)

    order = np.argsort(w, kind="stable")
    i, j, w = i[order], j[order], w[order]

    parent = np.arange(num_nodes, dtype=np.int64)
    rank = np.zeros(num_nodes, dtype=np.int32)
    size = np.ones(num_nodes, dtype=np.int64)
    threshold = np.full(num_nodes, c, dtype=np.float64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        parent[x] = root
        return root

    for ii, jj, ww in zip(i.tolist(), j.tolist(), w.tolist()):
        a = find(ii)
        b = find(jj)
        if a == b:
            continue
        if anchor[a] >= 0 and anchor[b] >= 0 and anchor[a] != anchor[b]:
            continue                      # would bridge two strong clusters
        if ww <= threshold[a] and ww <= threshold[b]:
            anc = max(anchor[a], anchor[b])
            if rank[a] > rank[b]:
                parent[b] = a
                size[a] += size[b]
                root = a
            else:
                parent[a] = b
                size[b] += size[a]
                if rank[a] == rank[b]:
                    rank[b] += 1
                root = b
            threshold[root] = ww + c / size[root]
            anchor[root] = anc

    return np.array([find(x) for x in range(num_nodes)], dtype=np.int32)
