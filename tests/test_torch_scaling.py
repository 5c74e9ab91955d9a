"""The sharded step's ``comm="tile"`` control and the weak-scaling tool
(``line3dpp_tpu_torch.tools.bench_scaling``), the port's counterparts of
``comm`` in ``line3dpp_tpu/parallel/sharded.py`` and of
``tools/bench_scaling.py``.

On the CPU:
* at world size 1 (one gloo rank) ``comm="tile"`` gives ``"gather"``'s
  outputs bit for bit; an unknown ``comm`` raises ``ValueError``;
* ``python -m line3dpp_tpu_torch.tools.bench_scaling --cpu --devices 1,2``
  at a small size prints one row per world size with the JAX tool's keys,
  ``V = per_shard * D`` and ``gather_mb`` by its formula, then its table;
* on the card a world size above the card count raises before any worker
  starts (the check itself, on a machine with no card);
* the tool starts its workers while the port of their rendezvous is bound
  by the store it holds, and two runs started at once both finish.

Marked ``gpu`` (this file imports no JAX, so they run on the card with
``--noconftest``): the same equality over NCCL at world size 1 with K1-K3
launched once a call, ``bench_scaling --devices 1``, and ``--devices 1,2``
where the machine has two cards (skipped otherwise)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_scaling.py
"""

import argparse
import errno
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from line3dpp_tpu_torch import bench
from line3dpp_tpu_torch.ops import kernels
from line3dpp_tpu_torch.parallel import run, sharded
from line3dpp_tpu_torch.tools import bench_scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {"devices", "V", "S", "N", "step_ms", "nocomm_ms", "compile_s",
            "gather_mb"}
# the tool at a small size: its own time limit
TOOL_TIMEOUT_S = 120
# the tool on the CPU at a small size, one torch thread a rank: on a host
# whose cores the other tests keep busy, a rank with a thread a core waits
# at every op for all its threads to be scheduled, and a 15 ms step takes
# seconds
CPU_ARGV = ("--cpu", "--devices", "1,2", "--per-shard", "2", "--segs", "64",
            "--nbrs", "2")
CPU_ENV = {"OMP_NUM_THREADS": "1"}


def _one_rank(backend: str):
    # one rank: an in-process store, no socket
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


@pytest.fixture
def one_rank_group():
    _one_rank("gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tile_and_gather(args, **kw):
    return [sharded.sharded_forward_step(comm=comm, **kw)(*args)
            for comm in ("tile", "gather")]


def test_tile_equals_gather_at_world_size_one(one_rank_group):
    host = run.example_inputs(V=8, S=16, N=2)
    args = [torch.from_numpy(a) for a in sharded.shard_inputs(0, 1, *host)]
    tile, gather = _tile_and_gather(args, **run.STATIC)
    assert int(gather.est_valid.sum()) > 0 and int(gather.aff_valid.sum()) > 0
    assert bench._same_bits(tile, gather)


def test_unknown_comm_raises():
    with pytest.raises(ValueError, match="comm"):
        sharded.sharded_forward_step(comm="ring")
    assert sharded.DEFAULTS["comm"] == "gather"


def _run_tools(*argvs, env=None) -> list[subprocess.CompletedProcess]:
    """The tool once for each of ``argvs``, all started at once, each in a
    session of its own.  At the time limit every run is killed with its
    workers and the test fails with what each printed."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "line3dpp_tpu_torch.tools.bench_scaling",
         *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=dict(os.environ, **(env or {})),
        start_new_session=True) for argv in argvs]
    deadline = time.monotonic() + TOOL_TIMEOUT_S
    printed = []
    try:
        for p in procs:
            printed.append(p.communicate(
                timeout=max(0.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs[len(printed):]:
            os.killpg(p.pid, signal.SIGKILL)
            printed.append(p.communicate())
        pytest.fail(f"bench_scaling ran past {TOOL_TIMEOUT_S} s:\n"
                    + "\n".join(f"--- {' '.join(p.args[3:])} (exit code "
                                f"{p.returncode})\nstdout:\n{out}\n"
                                f"stderr:\n{err}"
                                for p, (out, err) in zip(procs, printed)))
    return [subprocess.CompletedProcess(p.args, p.returncode, out, err)
            for p, (out, err) in zip(procs, printed)]


def _run_tool(*argv: str, env=None) -> subprocess.CompletedProcess:
    return _run_tools(argv, env=env)[0]


def _rows(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_bench_scaling_on_the_cpu_prints_jax_rows_and_table():
    r = _run_tool(*CPU_ARGV, env=CPU_ENV)
    assert r.returncode == 0, r.stdout + r.stderr
    rows = _rows(r.stdout)
    assert [row["devices"] for row in rows] == [1, 2]
    for row in rows:
        assert set(row) == ROW_KEYS
        assert (row["V"], row["S"], row["N"]) == (2 * row["devices"], 64, 2)
        assert row["gather_mb"] == round(
            (row["V"] * 64 * 20 + row["V"] * 64 * 36 + row["V"] * 4) / 1e6,
            1)
        assert row["step_ms"] > 0 and row["nocomm_ms"] > 0
        assert row["compile_s"] > 0
    table = r.stdout[r.stdout.index("weak scaling"):].splitlines()
    assert table[1].split() == ["D", "V", "step", "ms", "no-comm", "gather",
                                "ms", "share", "eff", "MB"]
    assert [line.split()[:2] for line in table[2:]] == [["1", "2"],
                                                        ["2", "4"]]


def test_run_world_holds_the_port_while_it_starts_the_workers(monkeypatch):
    """Every worker starts while its ``MASTER_PORT`` is bound by the
    parent's store (a fresh bind fails with ``EADDRINUSE``), with
    torchrun's switch that makes every rank a client of that store."""
    started = []

    class Worker:
        returncode = 0

        def __init__(self, cmd, stdout, env, **kw):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", int(env["MASTER_PORT"])))
                started.append((env, None))
            except OSError as e:
                started.append((env, e.errno))
            finally:
                s.close()
            if env["RANK"] == "0":
                stdout.write(json.dumps({"devices": 2}) + "\n")

        def poll(self):
            return 0

        def wait(self):
            return 0

    monkeypatch.setattr(bench_scaling.subprocess, "Popen", Worker)
    a = argparse.Namespace(per_shard=2, segs=64, nbrs=2, cpu=True)
    row, _ = bench_scaling.run_world(2, a)
    assert row == {"devices": 2}
    assert [env["RANK"] for env, _ in started] == ["0", "1"]
    assert len({env["MASTER_PORT"] for env, _ in started}) == 1
    for env, err in started:
        assert err == errno.EADDRINUSE, env["MASTER_PORT"]
        assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"
        assert env["WORLD_SIZE"] == "2"


def test_two_runs_at_once_both_print_their_rows():
    """Two runs started at the same moment each rendezvous on their own
    held store: both exit 0 and print a row for each world size."""
    for r in _run_tools(CPU_ARGV, CPU_ARGV, env=CPU_ENV):
        assert r.returncode == 0, r.stdout + r.stderr
        assert [row["devices"] for row in _rows(r.stdout)] == [1, 2]


def test_gather_mb_is_the_jax_formula():
    assert bench_scaling.gather_mb(26, 3000) == round(
        (26 * 3000 * (4 + 1) * 4 + 26 * 3000 * 9 * 4 + 26 * 4) / 1e6, 1)


@pytest.mark.parametrize("devices", ["1", "1,2", None])
def test_card_world_sizes_above_the_card_count_raise(monkeypatch, devices):
    """On a machine with no card, any world size is above the card count
    (and the card's default list is empty): the check raises, so no
    worker starts; with ``--cpu`` the same sizes pass."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    started = []
    monkeypatch.setattr(bench_scaling.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(ValueError, match="--devices"):
        bench_scaling.world_sizes(devices, cpu=False)
    argv = ["--devices", devices] if devices else []
    with pytest.raises(ValueError, match="--devices"):
        bench_scaling.main(argv)
    assert not started
    assert bench_scaling.world_sizes(devices, cpu=True) == (
        [int(x) for x in devices.split(",")] if devices else [1, 2, 4, 8])


def test_card_default_is_the_powers_of_two_up_to_the_card_count(
        monkeypatch):
    for cards, want in ((1, [1]), (3, [1, 2]), (4, [1, 2, 4]),
                        (8, [1, 2, 4, 8])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert bench_scaling.world_sizes(None, cpu=False) == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="world size 8"):
        bench_scaling.world_sizes("1,8", cpu=False)


def test_make_workload_below_800_segments_keeps_the_first_projections():
    small = bench.make_workload(V=2, S=64, N=1)
    full = bench.make_workload(V=2, S=800, N=1)
    assert small[0].shape == (2, 64, 4) and small[1].all()
    assert (small[0] == full[0][:, :64]).all()
    for a, b in zip(small[2:], full[2:]):
        assert (a == b).all()


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_tile_equals_gather_over_nccl(cuda):
    host = bench.make_workload(4, 1024, 6)
    _one_rank("nccl")
    try:
        args = [torch.from_numpy(a).to(cuda)
                for a in sharded.shard_inputs(0, 1, *host)]
        kernels.reset_launches()
        tile, gather = _tile_and_gather(args, knn=10, pair_chunk=6)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    assert int(gather.est_valid.sum()) > 0
    assert bench._same_bits(tile, gather)
    for name in ("match_pairs", "score_matches", "gather_target_estimates"):
        assert launches[name] == 2, (name, launches)


@pytest.mark.gpu
@pytest.mark.parametrize("devices", ["1", "1,2"])
def test_bench_scaling_on_the_card(cuda, devices):
    world = max(int(x) for x in devices.split(","))
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    r = _run_tool("--devices", devices)
    assert r.returncode == 0, r.stdout + r.stderr
    rows = _rows(r.stdout)
    assert [row["devices"] for row in rows] == [int(x) for x in
                                                devices.split(",")]
    assert all(set(row) == ROW_KEYS and row["V"] == 4 * row["devices"]
               for row in rows)
