"""Measured weak scaling of the view-sharded step on torch.distributed.

    python -m line3dpp_tpu_torch.tools.bench_scaling [--per-shard 4]
        [--segs 1024] [--nbrs 6] [--devices 1,2,4,8] [--cpu]

The port's counterpart of ``tools/bench_scaling.py``, with its flags and
its output.  The sharded forward step (``parallel/sharded.py``) runs at a
FIXED per-shard load (``--per-shard`` views a rank) on D ranks for each D
of ``--devices``; perfect weak scaling is a flat step time as D, and the
global view count V = per_shard * D, grow.  The gathered payloads
(segments, masks, the five estimate tables, the medians) grow with V, so
any cost of communication or imbalance shows as time growth against D = 1.

For each D the parent starts D worker processes, as ``torchrun`` would
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), which join one group through ``sharded.init_group``:
NCCL with rank r on ``cuda:r``, or gloo with ``--cpu`` (each rank then
takes 1/D of the host's threads).  Each builds
``bench.make_workload(V, S, N)``, takes its shard, and runs the step at
knn = 10, pair_chunk = N under ``comm="gather"`` and then under
``comm="tile"`` (every gather replaced by a local repeat: the same shapes
and work, no collective), so ``step_ms - nocomm_ms`` is the gathers' cost.
Each mode's first call is timed apart (``compile_s``: on the card the
kernels' load and the first CUDA and NCCL calls), then the best of 3 runs,
each ended by a device synchronize and taken as the slowest rank's time.
Rank 0 prints one JSON row (``devices``, ``V``, ``S``, ``N``, ``step_ms``,
``nocomm_ms``, ``compile_s``, ``gather_mb``, the analytic payload of one
step); the parent prints each row, then the table.  A worker that fails
makes the parent exit 1 with that worker's output.

Without ``--devices`` the ranks are 1, 2, 4, 8 with ``--cpu`` and, on
the card, the powers of two up to ``torch.cuda.device_count()``.  On the
card a D above the card count raises before any process starts: there is
no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import card_line, synchronize

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# timed runs of each mode, after its first call
RUNS = 3


def world_sizes(devices: str | None, cpu: bool) -> list[int]:
    """The world sizes to run: ``--devices`` parsed, or the default (1, 2,
    4, 8 on the CPU; on the card the powers of two up to the card count).
    On the card a size above the card count raises ``ValueError``."""
    cards = 0 if cpu else torch.cuda.device_count()
    if devices is None:
        sizes = ([1, 2, 4, 8] if cpu else
                 [2 ** i for i in range(cards.bit_length())])
    else:
        sizes = [int(x) for x in devices.split(",")]
    if not sizes or min(sizes) < 1:
        raise ValueError(f"--devices {devices}: no world size, or one "
                         f"below 1 ({cards} CUDA devices)")
    if not cpu and max(sizes) > cards:
        raise ValueError(f"--devices {devices}: world size {max(sizes)} "
                         f"needs as many CUDA devices and this machine has "
                         f"{cards}; pass --cpu to run the ranks on the CPU")
    return sizes


def gather_mb(V: int, S: int) -> float:
    """The analytic payload of one step's gathers, the JAX tool's formula:
    segments (f32) and masks (counted as a word), the five estimate tables
    (P1, P2, d1, d2, valid) and the medians, all O(V)."""
    return round((V * S * (4 + 1) * 4 + V * S * (3 + 3 + 1 + 1 + 1) * 4
                  + V * 4) / 1e6, 1)


def worker(world: int, per_shard: int, S: int, N: int, cpu: bool) -> None:
    """One rank of world size ``world``, set up from torchrun's
    environment; rank 0 prints the JSON row."""
    import torch.distributed as dist

    from ..bench import make_workload
    from ..parallel import sharded

    rank = int(os.environ["RANK"])
    if cpu:
        # the ranks share the host's cores, as a virtual mesh's devices do;
        # each with all of them would oversubscribe the host D times
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = sharded.init_group(rank, world, cpu=cpu)
    try:
        V = per_shard * world
        shard = sharded.shard_inputs(rank, world, *make_workload(V=V, S=S,
                                                                 N=N))
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in shard]

        def slowest(seconds: float) -> float:
            t = torch.tensor([seconds], dtype=torch.float64, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return float(t)

        def bench_mode(comm: str) -> tuple[float, float]:
            step = sharded.sharded_forward_step(knn=10, pair_chunk=N,
                                                comm=comm)

            # the all-reduce that ends each run lines the ranks up for
            # the next
            def run() -> float:
                synchronize(dev)
                t0 = time.perf_counter()
                step(*args)
                synchronize(dev)
                return slowest(time.perf_counter() - t0)

            first_s = run()
            return min(run() for _ in range(RUNS)) * 1e3, first_s

        step_ms, compile_s = bench_mode("gather")
        # the same shapes, work and host contention with the collectives
        # replaced by local repeats: the difference is the gathers' cost
        nocomm_ms, _ = bench_mode("tile")
        if rank == 0:
            print(json.dumps(dict(devices=world, V=V, S=S, N=N,
                                  step_ms=step_ms, nocomm_ms=nocomm_ms,
                                  compile_s=compile_s,
                                  gather_mb=gather_mb(V, S))), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(world: int, a) -> tuple[dict | None, str]:
    """Starts the ``world`` workers and waits for them: rank 0's row (None
    when a worker failed) and the output of rank 0 or of the first worker
    that failed.  A failed worker stops the others."""
    cmd = [sys.executable, "-m", "line3dpp_tpu_torch.tools.bench_scaling",
           "--worker", str(world), "--per-shard", str(a.per_shard),
           "--segs", str(a.segs), "--nbrs", str(a.nbrs)]
    if a.cpu:
        cmd.append("--cpu")
    port = _free_port()
    logs, procs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            logs.append(tempfile.TemporaryFile("w+"))
            # from the repository's root, ``-m`` finds the package
            procs.append(subprocess.Popen(cmd, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, env=env,
                                          cwd=REPO))
        codes = [None]
        while None in codes and not any(codes):
            time.sleep(0.05)
            codes = [p.poll() for p in procs]
        failed = next((r for r, c in enumerate(codes) if c), None)
        shown = 0 if failed is None else failed
        logs[shown].seek(0)
        out = logs[shown].read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rows = [line for line in out.splitlines() if line.startswith("{")]
    if failed is not None or not rows:
        return None, f"rank {shown} (exit code {procs[shown].returncode}):\n" \
                     f"{out}"
    return json.loads(rows[-1]), out


def main(argv: list[str] | None = None) -> list[dict]:
    """Runs every world size and prints the rows and the table; returns
    the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-shard", type=int, default=4)
    ap.add_argument("--segs", type=int, default=1024)
    ap.add_argument("--nbrs", type=int, default=6)
    ap.add_argument("--devices", default=None,
                    help="world sizes, comma-separated (default 1,2,4,8 "
                         "with --cpu, else the powers of two up to the "
                         "card count)")
    ap.add_argument("--worker", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU over gloo")
    a = ap.parse_args(argv)
    if a.worker:
        worker(a.worker, a.per_shard, a.segs, a.nbrs, a.cpu)
        return []

    sizes = world_sizes(a.devices, a.cpu)
    where = ("the CPU over gloo, not a card measurement" if a.cpu else
             f"{card_line()} over NCCL")
    rows = []
    for d in sizes:
        row, out = run_world(d, a)
        if row is None:
            print(f"D={d} FAILED: {out}", file=sys.stderr, flush=True)
            sys.exit(1)
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = rows[0]["step_ms"]
    print(f"\nweak scaling (fixed {a.per_shard} views/shard, S={a.segs}, "
          f"N={a.nbrs}; {where}; {os.cpu_count()} host cores; the no-comm "
          "control shares the same host contention):")
    print(f"{'D':>3} {'V':>5} {'step ms':>9} {'no-comm':>9} "
          f"{'gather ms':>10} {'share':>6} {'eff':>6} {'MB':>7}")
    for r in rows:
        g = r["step_ms"] - r["nocomm_ms"]
        print(f"{r['devices']:>3} {r['V']:>5} {r['step_ms']:>9.1f} "
              f"{r['nocomm_ms']:>9.1f} {g:>10.1f} "
              f"{g / r['step_ms']:>6.1%} {base / r['step_ms']:>6.2f} "
              f"{r['gather_mb']:>7.1f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
