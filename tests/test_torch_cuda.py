"""Kernels K1-K3 and the forward step on a CUDA device, against their plain
PyTorch versions, at small sizes.  Marked ``gpu``; each test asks the
``cuda`` fixture for the device and skips where there is none.

On a machine with a card and without JAX (the root conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import line3dpp_tpu_torch as lt
from line3dpp_tpu_torch.models import step
from line3dpp_tpu_torch.models.pipeline import STEP_ARRAYS
from line3dpp_tpu_torch.ops import affinity, kernels, matching, scoring
from line3dpp_tpu_torch.ops import geometry as geo
from line3dpp_tpu_torch.utils import golden

from test_torch_scenes import STEP_KW, pair_list, synthetic_step_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(inp, dev):
    src, tgt, F, pv = pair_list(inp)
    return matching.pair_tables(*(torch.from_numpy(a).to(dev) for a in (
        inp["segments"], inp["seg_mask"], inp["RtKinv"], inp["C"], src, tgt,
        F, pv)))


@pytest.mark.parametrize("knn", [1, 4, 10, 16])
def test_k1_equals_plain_bit_for_bit(cuda, knn):
    """Same expressions in the same order without FMA contraction: the
    kernel selects the same matches and gives the same depths exactly."""
    inp = synthetic_step_inputs(seed=1, V=6, S=700, N=4, n_lines=600)
    inp["pair_valid"][2, 1] = False
    inp["seg_mask"][3, 5:40] = False
    t = _tables(inp, cuda)
    got = matching.match_pairs_cuda(t, 0.25, knn)
    want = matching.match_pairs_plain(t, 0.25, knn, chunk=4)
    assert int(want.valid.sum()) > 1000
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_k2_equals_plain(cuda):
    """Only acosf/expf may round differently from torch's: 1e-5."""
    inp = synthetic_step_inputs(seed=2, V=6, S=300, N=4, n_lines=250)
    d = {n: torch.from_numpy(inp[n]).to(cuda) for n in STEP_ARRAYS}
    V, N = d["neighbor_ids"].shape
    knn = 6
    src = torch.arange(V, dtype=torch.int32,
                       device=cuda).repeat_interleave(N)
    pm = matching.match_pairs(d["segments"], d["seg_mask"], d["RtKinv"],
                              d["C"], src, d["neighbor_ids"].reshape(-1),
                              d["F"].reshape(-1, 3, 3),
                              d["pair_valid"].reshape(-1), 0.25, knn)
    r1, r2 = geo.segment_rays(d["RtKinv"][:, None], d["segments"])
    mid = 0.5 * (d["segments"][..., 0:2] + d["segments"][..., 2:4])
    rmid = geo.rays_from_pixels(d["RtKinv"][:, None], mid)
    nbr = d["neighbor_ids"].long()
    args = (r1.contiguous(), r2.contiguous(), rmid.contiguous(), d["C"],
            d["k_reg"], d["C"][nbr].contiguous(),
            d["k_reg"][nbr].contiguous(),
            *(step.regroup(x, V, N).contiguous()
              for x in (pm.d_p1, pm.d_p2, pm.valid)))
    kw = dict(knn=knn, two_sig_a_sqr=200.0, min_similarity=0.5,
              check_orientation=True)
    got = scoring.score_matches_cuda(*args, **kw)
    want = scoring.score_matches_plain(*args, chunk=500, **kw)
    assert torch.equal(got.valid, want.valid)
    assert int((want.score3d > 0).sum()) > 500
    torch.testing.assert_close(got.score3d, want.score3d, rtol=1e-5,
                               atol=1e-5)


def test_k3_equals_plain_bit_for_bit(cuda):
    rng = np.random.default_rng(0)
    V, S, N, k = 5, 300, 3, 7
    e = dict(
        est_P1=rng.normal(size=(V, S, 3)), est_P2=rng.normal(size=(V, S, 3)),
        est_d1=rng.uniform(1, 9, (V, S)), est_d2=rng.uniform(1, 9, (V, S)))
    e = {n: torch.tensor(v, dtype=torch.float32, device=cuda)
         for n, v in e.items()}
    est_valid = torch.tensor(rng.uniform(size=(V, S)) < 0.6, device=cuda)
    nbr = torch.tensor(rng.integers(0, V, (V, N)), dtype=torch.int32,
                       device=cuda)
    tgt = torch.tensor(rng.integers(0, S, (V, S, N * k)), dtype=torch.int32,
                       device=cuda)
    got = affinity.gather_target_estimates(
        e["est_P1"], e["est_P2"], e["est_d1"], e["est_d2"], est_valid, nbr,
        tgt, k)
    want = affinity.gather_target_estimates_plain(
        e["est_P1"], e["est_P2"], e["est_d1"], e["est_d2"], est_valid, nbr,
        tgt, k)
    for a, b in zip([*got.P1, *got.P2, got.d1, got.d2, got.valid],
                    [*want.P1, *want.P2, want.d1, want.d2, want.valid]):
        assert torch.equal(a, b)


def test_forward_step_cuda_launches_each_kernel_once(cuda):
    inp = synthetic_step_inputs(seed=3, V=6, S=64, N=4)
    kernels.reset_launches()
    got = step.forward_step(
        *(torch.from_numpy(inp[n]).to(cuda) for n in STEP_ARRAYS), **STEP_KW)
    torch.cuda.synchronize()
    step_kernels = {"match_pairs": 1, "score_matches": 1,
                    "gather_target_estimates": 1}
    assert kernels.LAUNCHES == {name: step_kernels.get(name, 0)
                                for name in kernels.LAUNCHES}
    want = step.forward_step(
        *(torch.from_numpy(inp[n]) for n in STEP_ARRAYS), **STEP_KW)
    for name in ("tgt_seg", "match_valid", "kept", "est_valid", "aff_valid"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    for name in ("score3d", "est_P1", "est_P2", "est_d1", "est_d2",
                 "aff_weight", "median_depth"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=1e-4,
                                   atol=1e-4)


def test_line3d_on_cuda_matches_cpu_on_bundled_subset(cuda):
    """6 bundled views (800 segments, 4 neighbours): same lines on the card
    as on the CPU up to transcendental rounding."""
    from line3dpp_tpu_torch.utils.testdata import load_views

    cfg = lt.Config(optimize=False, max_line_segments=800, num_neighbors=4)
    results = []
    for device in ("cuda", "cpu"):
        pipe = lt.Line3D(cfg, device=device)
        for v in load_views(range(6)):
            pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width,
                                              v.height), v.segments)
        pipe.match_images()
        results.append([l.segments3d for l in pipe.reconstruct_3d_lines()])
    got, want = results
    assert abs(len(got) - len(want)) <= 2
    tol = 0.01 * golden.scene_scale(np.concatenate(want))
    assert golden.line_match_metrics(got, want, tol)["count_f1"] >= 0.99


def test_line3d_defaults_to_cuda(cuda):
    assert lt.Line3D(lt.Config(optimize=False)).device.type == "cuda"
