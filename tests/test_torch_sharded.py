"""The view-sharded step of the port (line3dpp_tpu_torch.parallel) on the
CPU over gloo.

* Two processes (``python -m line3dpp_tpu_torch.parallel.run --cpu``, as
  ``tests/test_multihost.py`` runs JAX's ``tools/run_multihost.py``) give
  the single-process ``forward_step``'s outputs bit for bit, and print the
  same checksum.
* One process (world size 1) gives them bit for bit too, and a shard that
  does not divide the views raises ``ValueError``, as JAX's does.
* The single-process step against JAX's ``forward_step`` on the same
  scene, within ``tests/test_step_sharded.py``'s tolerances; the runner's
  scene is ``__graft_entry__._example_inputs``'s.
"""

import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from line3dpp_tpu.models import step as jax_step
from line3dpp_tpu_torch.models import step
from line3dpp_tpu_torch.parallel import run, sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _single(V=8):
    host = run.example_inputs(V=V, S=16, N=2)
    out = step.forward_step(*(torch.from_numpy(a) for a in host),
                            **run.STATIC)
    return host, out


def test_two_gloo_processes_equal_the_single_process_step(tmp_path):
    # the test holds the rendezvous store, and both processes join it as
    # clients: the port stays bound from its choice to the rendezvous
    store = sharded.hold_store(2)
    env = dict(os.environ, **sharded.AGENT_STORE_ENV)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    npz = tmp_path / "sharded.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "line3dpp_tpu_torch.parallel.run",
         f"--coordinator=127.0.0.1:{store.port}", "--num_processes=2",
         f"--process_id={pid}", "--cpu", "--views", "8", "--out", str(npz)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
    sums = [re.search(r"checksum est=(\d+) edges=(\d+) wsum=([\d.eE+-]+)",
                      out) for out in outs]
    assert all(sums), outs
    assert sums[0].groups() == sums[1].groups()

    _, want = _single()
    got = np.load(npz)
    assert int(sums[0].group(1)) == int(want.est_valid.sum()) > 0
    assert int(sums[0].group(2)) == int(want.aff_valid.sum()) > 0
    for name in want._fields:
        np.testing.assert_array_equal(got[name],
                                      getattr(want, name).numpy(), name)


@pytest.fixture
def one_rank_group():
    # one rank: an in-process store, no socket
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_equals_the_step_and_checks_the_shard(one_rank_group):
    host, want = _single()
    fn = sharded.sharded_forward_step(**run.STATIC)
    args = [torch.from_numpy(a) for a in sharded.shard_inputs(0, 1, *host)]
    got = fn(*args)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # a shard of 7 of the 8 views does not divide them
    short = [a[:7] if i in (0, 1, 5, 6, 7) else a for i, a in
             enumerate(args)]
    with pytest.raises(ValueError, match="not divisible"):
        fn(*short)


def test_shard_inputs_needs_a_divisible_view_count():
    host = run.example_inputs(V=8, S=16, N=2)
    with pytest.raises(ValueError, match="not divisible"):
        sharded.shard_inputs(0, 3, *host)
    parts = [sharded.shard_inputs(r, 4, *host) for r in range(4)]
    for i in (0, 1, 5, 6, 7):
        np.testing.assert_array_equal(
            np.concatenate([p[i] for p in parts]), host[i])
    for i in (2, 3, 4):
        assert all(p[i] is host[i] for p in parts)
    with pytest.raises(TypeError, match="unknown"):
        sharded.sharded_forward_step(not_an_option=True)


def test_single_process_step_against_jax():
    """The step the sharded ranks reproduce, against JAX's on the runner's
    scene (``test_step_sharded.py``'s tolerances)."""
    from __graft_entry__ import _example_inputs

    host, got = _single()
    for a, b in zip(host, _example_inputs(V=8, S=16, N=2)):
        np.testing.assert_array_equal(a, b)
    want = jax_step.forward_step(*(jnp.asarray(a) for a in host),
                                 **run.STATIC)
    w = lambda n: np.asarray(getattr(want, n))
    np.testing.assert_array_equal(got.est_valid.numpy(), w("est_valid"))
    assert w("est_valid").sum() > 0 and w("aff_valid").sum() > 0
    for n, tol in (("score3d", 2e-3), ("aff_weight", 2e-3),
                   ("est_P1", 1e-3)):
        np.testing.assert_allclose(getattr(got, n).numpy(), w(n), rtol=tol,
                                   atol=tol, err_msg=n)
