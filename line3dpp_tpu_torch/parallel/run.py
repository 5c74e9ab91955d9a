"""Multi-process execution of the view-sharded forward step.

Every process joins one ``torch.distributed`` group, builds the same seeded
scene, takes its shard of the view axis (``sharded.shard_inputs``), runs the
sharded step (``sharded.sharded_forward_step``) on its device, and gathers
the outputs of every rank; each then prints the same global checksum of
the step's outputs::

    [mh] process K: checksum est=... edges=... wsum=...

Usage, one process per device::

    torchrun --nproc_per_node=N -m line3dpp_tpu_torch.parallel.run [--views V]
    python -m line3dpp_tpu_torch.parallel.run --coordinator=HOST:PORT \\
        --num_processes=N --process_id=K [--cpu] [--views V] [--out F.npz]

``--cpu`` runs on the CPU over gloo (NCCL and the process's CUDA device
otherwise); ``--out`` makes rank 0 write the gathered outputs to an npz.
A parent that starts the processes can hold their rendezvous store
(``sharded.hold_store``) and give its port in ``--coordinator`` with
``sharded.AGENT_STORE_ENV`` in their environment: every process, 0 too,
then joins it as a client.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..camera import (Camera, CameraBatch, fundamental_matrix,
                      median_center_translation, rotation_from_rpy)
from . import sharded

STATIC = dict(
    epipolar_overlap=0.25, knn=4, two_sig_a_sqr=200.0, min_similarity=0.5,
    check_orientation=True, min_best_score=0.75, min_best_score_perc=0.10,
    min_affinity=0.5, pair_chunk=4,
)


def example_inputs(V: int = 4, S: int = 16, N: int = 2, seed: int = 0):
    """A tiny consistent multi-view scene (no padding degeneracies): the
    step's numpy arguments, ``segments`` to ``pair_valid``."""
    rng = np.random.default_rng(seed)
    n_lines = 6
    P = rng.uniform([-2, -1.5, 6], [2, 1.5, 10], size=(n_lines, 3))
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Q = P + d * rng.uniform(0.8, 1.6, size=(n_lines, 1))

    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]])
    cams = []
    for i in range(V):
        R = rotation_from_rpy(rng.normal() * 0.02, -0.05 * i + 0.12,
                              rng.normal() * 0.02)
        C = np.array([0.5 * i - 1.2, rng.normal() * 0.05, rng.normal() * 0.05])
        cams.append(Camera(K, R, -R @ C, 1920, 1080))

    segs = np.zeros((V, S, 4), np.float32)
    mask = np.zeros((V, S), bool)
    for i, cam in enumerate(cams):
        sv = np.hstack([cam.project(P), cam.project(Q)])
        segs[i, : len(sv)] = sv
        mask[i, : len(sv)] = True

    translation = median_center_translation(cams)
    cb = CameraBatch.from_cameras(cams, sigma_p=2.5, translation=translation)
    centered = [Camera(c.K, c.R, -c.R @ (c.C - translation), c.width,
                       c.height) for c in cams]

    neighbor_ids = np.zeros((V, N), np.int32)
    pair_valid = np.zeros((V, N), bool)
    F = np.zeros((V, N, 3, 3), np.float32)
    for i in range(V):
        nbrs = sorted((j for j in range(V) if j != i),
                      key=lambda j: np.linalg.norm(cams[i].C - cams[j].C))
        for g, j in enumerate(nbrs[:N]):
            neighbor_ids[i, g] = j
            pair_valid[i, g] = True
            F[i, g] = fundamental_matrix(centered[i], centered[j])

    return (segs, mask, cb.RtKinv.astype(np.float32),
            cb.C.astype(np.float32), cb.k_reg.astype(np.float32),
            neighbor_ids, F, pair_valid)


def gather_outputs(out, world: int) -> dict:
    """Every rank's shard of each output field, stacked in rank order, as
    host arrays (the same on every rank)."""
    full = {}
    for name, x in zip(out._fields, out):
        full[name] = sharded._gather(x, world, None).cpu().numpy()
    return full


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", help="HOST:PORT of rank 0 (without "
                    "it, torchrun's environment)")
    ap.add_argument("--num_processes", type=int)
    ap.add_argument("--process_id", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU over gloo")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--out", help="rank 0 writes the gathered outputs here")
    args = ap.parse_args(argv)

    if args.coordinator:
        rank, world = args.process_id, args.num_processes
    else:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    dev = sharded.init_group(rank, world, args.coordinator, cpu=args.cpu)
    try:
        print(f"[mh] process {rank}/{world} on {dev}", flush=True)
        host = example_inputs(V=args.views, S=16, N=2)  # the same everywhere
        shard = sharded.shard_inputs(rank, world, *host)
        fn = sharded.sharded_forward_step(**STATIC)
        out = fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in shard))
        full = gather_outputs(out, world)
        n_est = int(full["est_valid"].sum())
        n_edges = int(full["aff_valid"].sum())
        w_sum = float(full["aff_weight"].astype(np.float64).sum())
        print(f"[mh] process {rank}: checksum est={n_est} edges={n_edges} "
              f"wsum={w_sum:.6f}", flush=True)
        if args.out and rank == 0:
            np.savez(args.out, **full)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
