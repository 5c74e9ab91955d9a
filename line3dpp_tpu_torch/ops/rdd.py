"""Replicator-dynamics diffusion (RDD) over the affinity matrix.

Optional sharpening of the sparse affinity matrix before clustering
(``perform_rdd``; reference: performRDD line3D.cc:2026-2076, kernels
K_sparseMat_row_normalization / K_sparseMat_diffusion_step
cudawrapper.cu:432-544).  The counterpart of ``line3dpp_tpu.ops.rdd``:

    P <- row_normalize(W)
    repeat 10x:  P <- row_normalize(P ∘ (P @ W))
    W_out(i, j) <- min(P(i, j), P(j, i))

* :func:`rdd_dense` — the matrix as a dense (N, N) tensor: the test
  oracle and the route for small graphs.
* :func:`rdd_sparse` — the product sampled on the pattern of a CSR matrix
  with its true degrees, as the reference's sparse kernels do.  The
  entries of ``(P @ W)(r, c)`` are the wedges r -> k -> c of the pattern
  whose ends (r, c) are themselves an entry; :func:`wedge_plan` lists
  them once (their keys ``r * N + c`` looked up in the sorted pattern
  keys with ``searchsorted``, a bounded number of wedges at a time) and
  sorts them by their entry, so each iteration is one gather, one product
  and one segment sum over them, in a fixed order.

Plain torch on the caller's device (the card unless the caller names the
CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs

EPS = 1e-12
# wedges enumerated per step of wedge_plan (bounds its memory)
WEDGE_CHUNK = 1 << 22


def _row_normalize(M: torch.Tensor) -> torch.Tensor:
    return M / torch.clamp_min(M.sum(dim=1, keepdim=True), EPS)


def rdd_dense(W: torch.Tensor, iterations: int = 10,
              row_chunk: int = 2048) -> torch.Tensor:
    """Diffuse a dense symmetric affinity matrix; returns min-symmetrized
    P."""
    P = _row_normalize(W)
    for _ in range(iterations):
        P = torch.cat([Pc * (Pc @ W) for Pc in P.split(row_chunk)])
        P = _row_normalize(P)
    return torch.minimum(P, P.T)


class CSR:
    """The symmetric pattern of undirected edges: ``rowptr`` (N + 1,),
    ``row``/``col`` (nnz,) sorted by (row, col), ``w`` (nnz,) float32,
    ``rev`` (nnz,) the position of each entry's transpose, and ``pos``
    (E,) the position of edge e's (ei, ej) entry."""

    def __init__(self, ei, ej, ew, num_nodes: int, device):
        ei = torch.as_tensor(np.asarray(ei, np.int64), device=device)
        ej = torch.as_tensor(np.asarray(ej, np.int64), device=device)
        ew = torch.as_tensor(np.asarray(ew, np.float32), device=device)
        E = ei.numel()
        N = num_nodes
        src = torch.cat([ei, ej])
        dst = torch.cat([ej, ei])
        key = src * N + dst
        order = torch.argsort(key)
        self.key = key[order]
        self.row = src[order]
        self.col = dst[order]
        self.w = torch.cat([ew, ew])[order]
        inv = torch.empty_like(order)
        inv[order] = torch.arange(2 * E, device=device)
        self.pos = inv[:E]                       # entry (ei, ej)
        self.rev = torch.empty_like(order)
        self.rev[inv] = inv[(torch.arange(2 * E, device=device) + E)
                            % max(2 * E, 1)]
        self.deg = torch.bincount(self.row, minlength=N)
        self.rowptr = torch.zeros(N + 1, dtype=torch.int64, device=device)
        self.rowptr[1:] = torch.cumsum(self.deg, 0)
        self.num_nodes = N


def wedge_plan(csr: CSR):
    """The wedges of the sampled product: ``(a, b, lengths)`` with entry
    ``a = (r, k)`` and entry ``b = (k, c)`` for every (r, c) in the
    pattern, sorted by the entry (r, c) they add to (then by a and b), and
    ``lengths[t]`` the wedges of entry t."""
    dev = csr.key.device
    nnz = csr.key.numel()
    N = csr.num_nodes
    # wedges out of each entry a = (r, k): the deg(k) entries of row k
    per = csr.deg[csr.col]
    ends = torch.cumsum(per, 0)
    aa, bb, tt = [], [], []
    a0 = 0
    while a0 < nnz:
        # the entries whose wedges fit in one chunk (at least one entry)
        done = int(ends[a0 - 1]) if a0 else 0
        a1 = int(torch.searchsorted(ends, done + WEDGE_CHUNK, right=True))
        a1 = min(max(a1, a0 + 1), nnz)
        cnt = per[a0:a1]
        a = torch.repeat_interleave(
            torch.arange(a0, a1, device=dev), cnt)
        first = ends[a0:a1] - cnt                # global offset of a's wedges
        off = torch.arange(a.numel(), device=dev) + done - first[a - a0]
        b = csr.rowptr[csr.col[a]] + off
        key = csr.row[a] * N + csr.col[b]
        t = torch.searchsorted(csr.key, key).clamp_max(max(nnz - 1, 0))
        hit = csr.key[t] == key
        aa.append(a[hit])
        bb.append(b[hit])
        tt.append(t[hit])
        a0 = a1
    if not aa:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, torch.zeros(nnz, dtype=torch.int64, device=dev)
    a, b, t = torch.cat(aa), torch.cat(bb), torch.cat(tt)
    order = torch.argsort(t, stable=True)
    return a[order], b[order], torch.bincount(t, minlength=nnz)


def rdd_sparse(csr: CSR, iterations: int = 10) -> torch.Tensor:
    """Diffuse the CSR matrix over its pattern; returns the
    min-symmetrized entries (nnz,) float32."""
    a, b, lengths = wedge_plan(csr)
    Wb = csr.w[b]
    deg = csr.deg

    def row_normalize(P):
        s = torch.segment_reduce(P, "sum", lengths=deg, unsafe=True)
        return P / torch.clamp_min(s, EPS)[csr.row]

    P = row_normalize(csr.w)
    for _ in range(iterations):
        M = torch.segment_reduce(P[a] * Wb, "sum", lengths=lengths,
                                 unsafe=True)
        P = row_normalize(P * M)
    return torch.minimum(P, P[csr.rev])


@obs.spanned("recon.rdd")
def rdd_edges(ei, ej, ew, num_nodes: int, iterations: int = 10,
              device=None) -> np.ndarray:
    """Run RDD given undirected COO edges; returns the diffused weight of
    each edge (host float32).

    The symmetric sparse matrix is built from the edge list (one or both
    directions per undirected edge), diffused over its pattern only,
    min-symmetrized and sampled back at the callers' (i, j) in their
    order (performRDD, line3D.cc:2039-2057).  The diffusion runs on
    ``device``: a CUDA device by default, the CPU only when asked with
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rdd_edges runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    ei = np.asarray(ei)
    ej = np.asarray(ej)
    ew = np.asarray(ew, np.float32)
    if len(ei) == 0:
        return ew
    lo = np.minimum(ei, ej).astype(np.int64)
    hi = np.maximum(ei, ej).astype(np.int64)
    _, first, inv = np.unique(lo * num_nodes + hi, return_index=True,
                              return_inverse=True)
    csr = CSR(lo[first], hi[first], ew[first], num_nodes,
              torch.device(device))
    P = rdd_sparse(csr, iterations)
    return P[csr.pos].cpu().numpy()[inv.reshape(-1)]
