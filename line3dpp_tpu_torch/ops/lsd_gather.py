"""The two label gathers of the LSD detector (JAX package:
``line3dpp_tpu/ops/lsd_gather.py``).

After the tile-local components (``lsd_cc.cc_tiles``) and the border merge
(``lsd_cc.merge_tile_labels``, the map ``T`` from tile labels to merged
labels), every listed pixel needs its merged label ``T[lab.flat[idx]]``:

* :func:`apply_merge_dense` (K5): ``T`` applied to the dense label grid,
  ``INVALID`` where a pixel has no label;
* :func:`gather_labels` (K6): the merged grid at the pixel list's flat
  indices.  The JAX kernel (``gather_sorted``) needs sorted indices for its
  VMEM window; this one takes any order, so rounds 2 and 3 (whose lists are
  in label order) use it too.

Each wrapper launches its CUDA kernel (``csrc/lsd_gather.cu``) for CUDA
tensors and runs its plain torch version for CPU tensors; both are exact.
"""

from __future__ import annotations

import torch

from . import kernels
from .lsd_cc import INVALID


def apply_merge_dense_plain(lab: torch.Tensor, T: torch.Tensor
                            ) -> torch.Tensor:
    valid = (lab >= 0) & (lab < T.numel())
    return torch.where(valid, T[torch.where(valid, lab, 0).long()], INVALID)


def gather_labels_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[idx]


def apply_merge_dense_cuda(lab: torch.Tensor, T: torch.Tensor
                           ) -> torch.Tensor:
    """Kernel K5 on an int32 (hp, wp) label grid and its (hp * wp,) map."""
    dev = lab.device
    kernels.check("lab", lab, torch.int32, tuple(lab.shape), dev)
    kernels.check("T", T, torch.int32, (lab.numel(),), dev)
    if lab.numel() >= INVALID:
        raise ValueError(f"{lab.numel()} pixels do not fit int32 labels "
                         f"below INVALID = 2**30")
    out = torch.empty_like(lab)
    kernels.launch("l3d_apply_merge_dense", kernels.ptr(lab), kernels.ptr(T),
                   lab.numel(), kernels.ptr(out), kernels.stream(dev))
    kernels.LAUNCHES["apply_merge_dense"] += 1
    return out


def gather_labels_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel K6: ``src[idx]`` of a flat int32 ``src`` at int64 ``idx``,
    which must lie in range."""
    dev = src.device
    kernels.check("src", src, torch.int32, (src.numel(),), dev)
    kernels.check("idx", idx, torch.int64, (idx.numel(),), dev)
    out = torch.empty(idx.numel(), dtype=torch.int32, device=dev)
    kernels.launch("l3d_gather_labels", kernels.ptr(src), kernels.ptr(idx),
                   idx.numel(), kernels.ptr(out), kernels.stream(dev))
    kernels.LAUNCHES["gather_labels"] += 1
    return out


def apply_merge_dense(lab: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``T[lab]`` where ``lab`` is a valid label, ``INVALID`` elsewhere."""
    if lab.is_cuda:
        return apply_merge_dense_cuda(lab.contiguous(), T.contiguous())
    return apply_merge_dense_plain(lab, T)


def gather_labels(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` for a flat int32 ``src`` and int64 indices."""
    if src.is_cuda:
        return gather_labels_cuda(src.contiguous(), idx.contiguous())
    return gather_labels_plain(src, idx)
