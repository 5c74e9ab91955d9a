"""More than one device: the forward step sharded over the view axis.

The counterpart of ``line3dpp_tpu.parallel.sharded`` on ``torch.distributed``,
one process per device.  Views are sharded across the processes of a group:
each rank owns a contiguous block of views' segments and computes matching,
scoring, filtering and affinity for the pairs whose *source* view is local.
The only communication is

* one ``all_gather_into_tensor`` of the (small) segment tensors and masks,
  so that any rank can read its targets' segments;
* one ``all_gather_into_tensor`` of each of the five per-view estimate
  tables before the affinity stage (the targets' estimates live on other
  ranks; kernel K3 then reads the global tables, ``V_tab = V``);
* one of the per-view median depths (V scalars) for the scene-level depth
  cutoff (line3D.cc:1758-1774).

Everything else is local.  Cameras (V x (3, 3) matrices) are replicated.
NCCL moves CUDA tensors; gloo, for a caller that asks for the CPU, moves
the masks as ``uint8``.

``comm="tile"``, a benchmark's control (``tools/bench_scaling.py``),
replaces each gather with a local repeat of the rank's shard
(:func:`_local_step`).
"""

from __future__ import annotations

import functools
import os

import torch
import torch.distributed as dist

from ..models.step import (EPS, StepOutputs, _match_score_filter,
                           _median_positive, step_outputs)
from ..ops import affinity as affinity_ops

# the JAX package's options; ``use_pallas`` and ``pallas_interpret`` are
# accepted and ignored (the kernels run exactly when the tensors are on a
# CUDA device)
DEFAULTS = dict(epipolar_overlap=0.25, knn=10, two_sig_a_sqr=200.0,
                min_similarity=0.5, check_orientation=True,
                min_best_score=0.75, min_best_score_perc=0.10,
                min_affinity=0.5, pair_chunk=8, use_pallas=False,
                pallas_interpret=False, comm="gather")
# the values of ``comm``: the collectives, or their local stand-in
COMMS = ("gather", "tile")


def init_group(rank: int, world: int, address: str | None = None,
               cpu: bool = False) -> torch.device:
    """Join the default process group, one process per device (the
    counterpart of ``make_mesh``), and return this rank's device.

    ``address`` is ``host:port`` of rank 0; without it the group is set up
    from the environment that ``torchrun`` gives (``env://``).  NCCL on
    ``cuda:<local rank>``; gloo on the CPU where ``cpu`` asks for it."""
    backend = "gloo" if cpu else "nccl"
    method = f"tcp://{address}" if address else "env://"
    dist.init_process_group(backend, init_method=method, rank=rank,
                            world_size=world)
    if cpu:
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def _gather(x: torch.Tensor, world: int, group) -> torch.Tensor:
    """The tensors of every rank stacked along axis 0, in rank order."""
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    out = torch.empty((world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.bool() if is_bool else out


def _local_step(seg_local, mask_local, RtKinv, C, k_reg, nbr_local, F_local,
                pv_local, *, group, epipolar_overlap, knn, two_sig_a_sqr,
                min_similarity, check_orientation, min_best_score,
                min_best_score_perc, min_affinity, pair_chunk, use_pallas,
                pallas_interpret, comm) -> StepOutputs:
    """One rank's part of the sharded step.

    ``comm="tile"`` is a BENCHMARK-ONLY control: every gather is replaced
    by a local repeat of the rank's shard along axis 0 (JAX's ``jnp.tile``)
    to the gathered shape, so the shapes and the work downstream are those
    of ``"gather"`` but no collective runs.  The outputs are meaningless in
    that mode except at world size 1, where they equal ``"gather"``'s bit
    for bit; ``tools/bench_scaling.py`` takes the difference of the two
    times as the gathers' cost."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    V = C.shape[0]
    Vl = seg_local.shape[0]
    if V % world or Vl * world != V:
        raise ValueError(f"V={V} not divisible by the world size {world} "
                         f"into shards of {Vl} views")
    if comm == "tile":
        gather = lambda x: x.repeat(world, *(1,) * (x.dim() - 1))
    else:
        gather = functools.partial(_gather, world=world, group=group)

    # --- collective 1: segments of all views (targets may be remote)
    seg_all = gather(seg_local)
    mask_all = gather(mask_local)
    src_rows = torch.arange(rank * Vl, (rank + 1) * Vl, dtype=torch.int32,
                            device=seg_local.device)
    msf = _match_score_filter(
        seg_all, mask_all, RtKinv, C, k_reg, nbr_local, F_local, pv_local,
        epipolar_overlap=epipolar_overlap, knn=knn,
        two_sig_a_sqr=two_sig_a_sqr, min_similarity=min_similarity,
        check_orientation=check_orientation, min_best_score=min_best_score,
        min_best_score_perc=min_best_score_perc, pair_chunk=pair_chunk,
        src_rows=src_rows)
    fm = msf["fm"]
    median_local = msf["median_depth"]

    # --- collective 2: estimates and median depths for the affinity stage
    tgt_est = affinity_ops.FilteredMatches(
        kept=None, est_valid=gather(fm.est_valid), est_P1=gather(fm.est_P1),
        est_P2=gather(fm.est_P2), est_d1=gather(fm.est_d1),
        est_d2=gather(fm.est_d2), max_score=None)
    median_all = gather(median_local)
    med_scene = _median_positive(median_all[None], median_all[None] > EPS)[0]

    aff = affinity_ops.affinity_dense(
        fm, msf["t_seg"], nbr_local, k_reg[src_rows.long()], median_local,
        med_scene, two_sig_a_sqr, min_affinity, tgt_est=tgt_est,
        k_table=k_reg, median_depth_table=median_all)
    return step_outputs(msf, aff)


def sharded_forward_step(group=None, **static):
    """The view-sharded forward step of a process group (the default group
    when None).

    Returns ``fn(segments, seg_mask, RtKinv, C, k_reg, neighbor_ids, F,
    pair_valid)``, which every rank calls with its shard of the view axis
    of segments, masks and pair tables (:func:`shard_inputs`) and the
    replicated camera tables, and which returns the rank's shard of the
    ``StepOutputs``.  V must be divisible by the world size.  ``comm`` is
    ``"gather"`` (the collectives) or ``"tile"`` (their local stand-in, a
    benchmark's control whose outputs are meaningless above world size 1;
    see :func:`_local_step`); any other value raises ``ValueError``."""
    opts = dict(DEFAULTS)
    unknown = set(static) - set(opts)
    if unknown:
        raise TypeError(f"unknown options {sorted(unknown)}")
    opts.update(static)
    if opts["comm"] not in COMMS:
        raise ValueError(f"comm={opts['comm']!r}: expected one of {COMMS}")
    return functools.partial(_local_step, group=group, **opts)


def shard_inputs(rank: int, world: int, segments, seg_mask, RtKinv, C, k_reg,
                 neighbor_ids, F, pair_valid) -> tuple:
    """Rank ``rank``'s arguments of the sharded step from the global
    arrays: its contiguous block of the view axis of segments, masks and
    pair tables, and the camera tables whole."""
    V = segments.shape[0]
    if V % world:
        raise ValueError(f"V={V} not divisible by the world size {world}")
    Vl = V // world
    sl = slice(rank * Vl, (rank + 1) * Vl)
    return (segments[sl], seg_mask[sl], RtKinv, C, k_reg, neighbor_ids[sl],
            F[sl], pair_valid[sl])
