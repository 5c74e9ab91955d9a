"""The sweep kernel (``csrc/sweep.cu`` behind ``sweep.sweep_clusters_cuda``)
against the numpy path (``sweep.sweep_clusters_plain``:
``fitting.project_members_onto_lines_np``, ``sweep_all_flat`` and the
reference views' lexsort) on the same card.  Marked ``gpu``; each test
skips where there is no CUDA device.

On a machine with a card and without JAX (the root conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_sweep_cuda.py

No tolerance: the kernel projects in float64 in numpy's order and the rest
is comparison and integer logic, so its intervals (cluster, start, end)
are the numpy path's, in the same order, with the same bits, and so are
its reference views.  Held on:

* the 26 cached views under ``Config(optimize=False)``, under the
  collinear_rdd options (``perform_rdd``, ``collinearity_t`` = 2) and under
  the default ``Config()`` (bundled lines): ``sweep_clusters``' inputs
  captured from one pipeline run each on the card;
* the seeded cases of ``test_torch_scenes.sweep_case`` at visibility 2, 3
  and 5: clusters of 0, 1, 2 and 3 kept members, ties of |p - 1| and of
  the distance to the border, parallel rays, every member in one camera,
  40 views, clusters past ``sweep.SMEM_MEMBERS`` (the global scratch), no
  member and no cluster.

Each call launches once by the counter (none without members) and two
calls give the same bits; arguments the kernel does not take raise before
any launch; a reconstruction on the card launches the kernel once.
"""

import numpy as np
import pytest
import torch

from line3dpp_tpu_torch.ops import kernels, sweep

from test_torch_scenes import SWEEP_CASES, sweep_arguments, sweep_case

pytestmark = pytest.mark.gpu

CONFIGS = {"unbundled": dict(optimize=False),
           "collinear_rdd": dict(optimize=False, perform_rdd=True,
                                 collinearity_t=2.0),
           "bundled": {}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want) -> None:
    """Identical intervals in identical order, bit for bit, and identical
    reference views."""
    assert len(got) == len(want) == 4
    for g, w, dtype in zip(got, want, (np.int64, np.float64, np.float64,
                                       np.int32)):
        assert g.dtype == w.dtype == dtype
        assert g.shape == w.shape
        if dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w)


def _run_pipeline(kw: dict, capture: list | None = None):
    """One pipeline run of the 26 cached views on the card under
    ``Config(**kw)``; ``capture`` receives ``sweep_clusters``' calls."""
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.utils.testdata import load_views

    orig = sweep.sweep_clusters

    def wrapped(*args, **fkw):
        capture.append((args, fkw))
        return orig(*args, **fkw)

    if capture is not None:
        sweep.sweep_clusters = wrapped
    try:
        pipe = lt.Line3D(lt.Config(**kw), device="cuda")
        for v in load_views():
            pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width,
                                              v.height), v.segments)
        pipe.match_images()
        pipe.reconstruct_3d_lines()
    finally:
        sweep.sweep_clusters = orig
    return pipe


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def captured(request):
    """``sweep_clusters``' arguments from one pipeline run of the 26 cached
    views on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    calls = []
    _run_pipeline(CONFIGS[request.param], calls)
    assert len(calls) == 1
    args, fkw = calls[0]
    assert args[0].shape == (26, 3000, 3) and args[0].is_cuda
    return args


def _large(mc, C: int) -> int:
    """The clusters past the kernel's slice of shared memory."""
    return int((np.bincount(mc, minlength=C) > sweep.SMEM_MEMBERS).sum())


def test_scene_equals_the_numpy_path(captured):
    got = sweep.sweep_clusters_cuda(*captured)
    want = sweep.sweep_clusters_plain(*captured)
    # RDD's clusters of the collinear_rdd options pass the slice
    assert got[4] == _large(captured[6], captured[9]) and want[4] == 0
    assert len(want[0]) > 1000
    _same(got[:4], want[:4])


def test_scene_through_the_dispatcher_launches_once(captured):
    before = kernels.LAUNCHES["sweep"]
    stats = {}
    first = sweep.sweep_clusters(*captured, stats=stats)
    assert kernels.LAUNCHES["sweep"] == before + 1
    second = sweep.sweep_clusters(*captured)
    assert kernels.LAUNCHES["sweep"] == before + 2
    _same(first, second)
    C, mc = captured[9], captured[6]
    assert stats == dict(clusters=C, members=len(mc),
                         intervals=len(first[0]),
                         large_clusters=_large(mc, C))


@pytest.mark.parametrize("visibility", [2, 3, 5])
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_seeded_cases_equal_the_numpy_path(cuda, name, visibility):
    case = sweep_case(name, seed=20 + visibility)
    args = sweep_arguments(case, visibility, cuda)
    before = kernels.LAUNCHES["sweep"]
    stats = {}
    got = sweep.sweep_clusters(*args, stats=stats)
    launched = kernels.LAUNCHES["sweep"] - before
    assert launched == (1 if len(case["mc"]) and case["C"] else 0)
    _same(got, sweep.sweep_clusters_plain(*args)[:4])
    large = _large(case["mc"], case["C"])
    assert stats["large_clusters"] == large
    if name == "large":
        assert large == 3
    if name in ("random", "ties", "large") and visibility <= 3:
        assert len(got[0]) > 0
    _same(sweep.sweep_clusters(*args), got)


def test_the_csr_can_be_given(cuda):
    """The pipeline hands the wrapper the CSR it shares with the assembly:
    the same result as the wrapper's own."""
    case = sweep_case("random", seed=3)
    args = sweep_arguments(case, 3, cuda)
    csr = sweep.cluster_csr(case["mc"], case["C"])
    _same(sweep.sweep_clusters(*args, csr=csr), sweep.sweep_clusters(*args))


def _bad_arguments(args):
    """Argument lists the kernel does not take, each with one fault."""
    args = list(args)
    out = []
    for i, bad in ((0, args[0].double()), (1, args[1][:, :-1]),
                   (2, args[2].cpu()),
                   (2, args[2].transpose(0, 1).contiguous().transpose(0, 1)),
                   (3, args[3][:-1]), (4, args[4][:, :2]),
                   (5, args[5][:-1]), (6, args[6].astype(np.float32)),
                   (6, args[6] + args[9]), (7, args[7] - 1),
                   (8, args[8][:-1]), (10, 0)):
        a = list(args)
        a[i] = bad
        out.append(a)
    return out


def test_bad_arguments_raise_before_any_launch(cuda):
    args = sweep_arguments(sweep_case("random", seed=4), 3, cuda)
    before = kernels.LAUNCHES["sweep"]
    for bad in _bad_arguments(args):
        with pytest.raises(ValueError):
            sweep.sweep_clusters(*bad)
    with pytest.raises(ValueError):
        sweep.sweep_clusters(*args, csr=(np.arange(3), np.arange(2)))
    assert kernels.LAUNCHES["sweep"] == before


def test_a_reconstruction_launches_the_kernel_once(cuda):
    """The dispatcher runs once a reconstruction on the card, and
    ``Line3D.sweep_stats`` counts it."""
    pipe = _run_pipeline(CONFIGS["unbundled"])
    before = kernels.LAUNCHES["sweep"]
    lines = pipe.reconstruct_3d_lines()
    assert kernels.LAUNCHES["sweep"] == before + 1
    stats = pipe.sweep_stats
    assert stats["large_clusters"] == 0
    assert len(lines) <= stats["clusters"] <= stats["members"]
    assert stats["intervals"] >= len(lines) > 2000
