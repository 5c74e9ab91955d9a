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
from line3dpp_tpu_torch.utils import golden

from test_torch_scenes import STEP_KW, agreeing_scoring_case, \
    k2_arguments, k2_scene_arguments, pair_list, synthetic_step_inputs

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
    kernel selects the same matches and gives the same depths exactly.
    k <= ``matching.LIST_LEN``, the cells' k = 10 among them: each
    source's exact top-k in its shared-memory list, no overflow path."""
    inp = synthetic_step_inputs(seed=1, V=6, S=700, N=4, n_lines=600)
    inp["pair_valid"][2, 1] = False
    inp["seg_mask"][3, 5:40] = False
    t = _tables(inp, cuda)
    got = matching.match_pairs_cuda(t, 0.25, knn)
    want = matching.match_pairs_plain(t, 0.25, knn, chunk=4)
    assert int(want.valid.sum()) > 1000
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _crafted_tables(dev, S=1100):
    """Synthetic tables whose target view holds exact duplicates at the
    chunk borders (511/512 and 1023/1024 of K1's 512-target chunks), a
    fully masked source view, an invalid pair, and a crafted pair p0 whose
    first sources cut two unit-length targets exactly at chosen t1, t2 with
    every depth sign positive: overlaps exactly at and one float above the
    cut, outer_px exactly 1 and one float below, inner exactly -EPS."""
    inp = synthetic_step_inputs(seed=11, V=6, S=S, N=4, n_lines=900)
    segs, mask = inp["segments"], inp["seg_mask"]
    segs[:, 900:S] = segs[:, 0:S - 900]              # every border twice
    mask[:, 900:S] = mask[:, 0:S - 900]
    for a, b in ((511, 512), (1023, 1024), (510, 513)):
        segs[:, b] = segs[:, a]
        mask[:, b] = mask[:, a]
    inp["pair_valid"][4, 2] = False
    mask[5] = False                                  # all sources masked
    p0 = 0
    tgt = int(inp["neighbor_ids"][0, 0])
    assert tgt != 5 and mask[0, :12].all()
    c0, c1 = 600, 601
    segs[tgt, c0] = (0.0, 0.0, 1.0, 0.0)             # length 1 exactly
    segs[tgt, c1] = (0.0, 0.0, 2.0, 0.0)
    mask[tgt, c0] = mask[tgt, c1] = True
    t = _tables(inp, dev)
    t = matching.PairTables(*(x.clone() for x in t))
    f = lambda v: float(np.float32(v))
    up = lambda v: float(np.nextafter(np.float32(v), np.float32(2)))
    down = lambda v: float(np.nextafter(np.float32(v), np.float32(-2)))
    eps = f(1e-12)
    # (t1, t2) for sources 0.. of view 0 against the vertical line x = t
    # of the target view: with c0 = (0, 0)-(1, 0), t is the parameter
    cuts = [(0.0, 0.25), (0.0, up(0.25)), (0.0, 1.0), (-eps, 0.5),
            (-1.0, -eps), (-1.0, down(-eps)), (0.75, up(1.0)),
            (down(0.0), 0.25), (1.0, up(1.0)), (0.0, 1.0), (0.25, 1.0),
            (f(1e-40), 0.5)]
    z = torch.tensor([0.0, 0.0, 1.0], device=dev)
    for s, (t1, t2) in enumerate(cuts):
        t.e1[p0, s] = torch.tensor([1.0, 0.0, -t1], device=dev)
        t.e2[p0, s] = torch.tensor([1.0, 0.0, -t2], device=dev)
        for tab in (t.r1, t.r2, t.n):
            tab[0, s] = z
        t.num_tgt[p0, s] = 1.0
    for c in (c0, c1):
        for tab in (t.r1, t.r2, t.n):
            tab[tgt, c] = z
        t.num_src[p0, c] = 1.0
    # outer_px = outer * seglen: exactly 1 for c0, one float below for c1
    t.seglen[tgt, c0] = 1.0
    t.seglen[tgt, c1] = down(1.0)
    return t, len(cuts), (c0, c1)


@pytest.mark.parametrize("knn", [1, 10, 16])
def test_k1_equals_plain_at_the_edges(cuda, knn):
    """Ties across chunk borders, overlaps and outer_px exactly at their
    thresholds, inner at -EPS, a masked view and an invalid pair: the
    pre-test must keep every candidate the exact test accepts, so the
    kernel equals the plain version bit for bit, at the cells' k = 10 and
    around it (the top-k lists, no overflow path)."""
    t, _, (c0, c1) = _crafted_tables(cuda)
    got = matching.match_pairs_cuda(t, 0.25, knn)
    want = matching.match_pairs_plain(t, 0.25, knn, chunk=4)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not want.valid[4 * 4 + 2].any() and not want.valid[20:].any()
    # the crafted candidates, from the plain version: overlap exactly 0.25
    # is rejected, one float above kept; outer_px 1 kept, below rejected
    sel = lambda s: {int(i) for i, v in zip(want.tgt_seg[0, s],
                                            want.valid[0, s]) if v}
    if knn >= 2:
        assert c0 not in sel(0) and c0 in sel(1) and c0 in sel(2)
        assert c1 not in sel(2)
    # duplicates: where both copies are selected, the lower index first
    tg, ok = want.tgt_seg, want.valid
    for a, b in ((511, 512), (1023, 1024)):
        first = (tg == a) & ok
        pos_a = torch.where(first, torch.arange(knn, device=cuda), knn)
        pos_b = torch.where((tg == b) & ok, torch.arange(knn, device=cuda),
                            knn)
        both = (pos_a.min(-1).values < knn) & (pos_b.min(-1).values < knn)
        assert bool((pos_a.min(-1).values[both]
                     < pos_b.min(-1).values[both]).all())
    assert int(want.valid.sum()) > 1000


def test_k2_equals_plain(cuda):
    """Only acosf/expf may round differently from torch's: 1e-5."""
    inp = synthetic_step_inputs(seed=2, V=6, S=300, N=4, n_lines=250)
    knn = 6
    args = k2_scene_arguments(inp, knn, cuda)
    kw = dict(knn=knn, two_sig_a_sqr=200.0, min_similarity=0.5,
              check_orientation=True)
    got = scoring.score_matches_cuda(*args, **kw)
    want = scoring.score_matches_plain(*args, chunk=500, **kw)
    assert torch.equal(got.valid, want.valid)
    assert int((want.score3d > 0).sum()) > 500
    torch.testing.assert_close(got.score3d, want.score3d, rtol=1e-5,
                               atol=1e-5)


def _k2_case(dev, seed=0, V=4, S=64, N=4, k=10):
    """Scoring arguments whose hypotheses agree up to noise, so that many
    pairs pass: where the table is that large, segment (0, 3) has no valid
    slot and segment (1, 5) one."""
    case, k = agreeing_scoring_case(np.random.default_rng(seed), V, S, N, k)
    if V > 1 and S > 5:
        valid = case["valid"]
        valid[0, 3] = False
        valid[1, 5] = False
        valid[1, 5, -1] = True
    return k2_arguments(case, dev), k


def _k2_against_exact_path_and_plain(args, kw):
    """The kernel with its pre-test equals it without (every pair through
    the exact path, as the kernel ran them before its pre-test) bit for
    bit, and its plain version up to acosf/expf against torch's."""
    got = scoring.score_matches_cuda(*args, **kw)
    every = scoring.score_matches_cuda(*args, pretest=False, **kw)
    want = scoring.score_matches_plain(*args, chunk=64, **kw)
    assert torch.equal(got.score3d, every.score3d)
    assert torch.equal(got.valid, every.valid)
    assert torch.equal(got.valid, want.valid)
    torch.testing.assert_close(got.score3d, want.score3d, rtol=1e-5,
                               atol=1e-5)
    return got


@pytest.mark.parametrize("case", ["default", "knn1", "M1024",
                                  "no_orientation", "min_similarity_0",
                                  "min_similarity_1", "wide_angle"])
def test_k2_pretest_changes_no_bit(cuda, case):
    kw = dict(two_sig_a_sqr=200.0, min_similarity=0.5,
              check_orientation=case != "no_orientation")
    shape = dict(knn1=dict(N=8, k=1), M1024=dict(V=2, S=6, N=4, k=256))
    args, knn = _k2_case(cuda, **shape.get(case, {}))
    if case.startswith("min_similarity"):
        kw["min_similarity"] = float(case[-1])
    if case == "wide_angle":   # theta* >= 90 degrees: no angle test
        kw["two_sig_a_sqr"] = 1e6
    kernels.reset_launches()
    got = _k2_against_exact_path_and_plain(args, dict(knn=knn, **kw))
    assert kernels.LAUNCHES["score_matches"] == 2
    assert not got.valid[0, 3].any()
    assert not bool(got.score3d[0, 3].any())
    if case == "min_similarity_1":
        assert not bool(got.score3d.any())
    else:
        assert int((got.score3d > 0).sum()) > 50


@pytest.mark.parametrize("term", ["angle", "depth"])
def test_k2_pair_exactly_at_the_cut(cuda, term):
    """A segment with two valid slots in different groups: the kernel's own
    similarity s of the pair (its score at min_similarity 0), then
    min_similarity = s (fails) and one float below (passes), with and
    without the pre-test.  ``angle``: the second slot's far depth moved
    by 0.5% and large regularisers, so sim = sim_a; ``depth``: both its
    depths times 1.001, so the directions agree and sim = sim_p."""
    args, knn = _k2_case(cuda, V=1, S=1, N=2, k=2)
    args = [a.clone() for a in args]
    d1, d2, valid = args[7], args[8], args[9]
    valid.zero_()
    valid[0, 0, 0] = valid[0, 0, knn] = True
    if term == "angle":
        # regularisers of ~d^2: sim_p ~ 1 - 3e-5, the angle (~5 degrees)
        # decides
        args[4].fill_(1.0)
        args[6].fill_(1.0)
        d1[0, 0, knn] = d1[0, 0, 0]
        d2[0, 0, knn] = d2[0, 0, 0] * 1.005
    else:
        d1[0, 0, knn] = d1[0, 0, 0] * 1.001
        d2[0, 0, knn] = d2[0, 0, 0] * 1.001
    kw = dict(knn=knn, two_sig_a_sqr=200.0, check_orientation=False)
    s = scoring.score_matches_cuda(*args, min_similarity=0.0, **kw)
    sim = float(s.score3d[0, 0, 0])
    assert 0.05 < sim < 0.999
    below = float(np.nextafter(np.float32(sim), np.float32(0)))
    for ms, want in ((sim, 0.0), (below, sim)):
        for pretest in (True, False):
            got = scoring.score_matches_cuda(*args, min_similarity=ms,
                                             pretest=pretest, **kw)
            assert float(got.score3d[0, 0, 0]) == want, (ms, pretest)


def _one_line_tables(dev, S=1500, seed=5):
    """Every view's S segments are copies of one line's projection, half
    exact (ties) and half with 0.3 px of noise: each source row keeps more
    than 1024 matches, which K1's overflow path lists past its shared
    memory into its global scratch and sorts there."""
    inp = synthetic_step_inputs(seed=seed, V=3, S=S, N=2, n_lines=S)
    segs = inp["segments"]
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, 0.3, segs.shape).astype(np.float32)
    noise[:, ::2] = 0.0
    segs[:] = segs[:, :1] + noise
    inp["seg_mask"][:] = True
    inp["seg_mask"][1, 7] = False
    return _tables(inp, dev)


@pytest.mark.parametrize("knn", [17, 40, 700])
def test_k1_general_form_equals_plain_bit_for_bit(cuda, knn):
    """At k above the cells' (k > 16; k = 700 = S past ``LIST_LEN``, the
    overflow path) the kernel selects what the plain version's stable sort
    selects, in its order, with the same depths; k = S keeps every valid
    match.  One launch a call."""
    inp = synthetic_step_inputs(seed=1, V=6, S=700, N=4, n_lines=600)
    inp["pair_valid"][2, 1] = False
    inp["seg_mask"][3, 5:40] = False
    t = _tables(inp, cuda)
    kernels.reset_launches()
    got = matching.match_pairs_cuda(t, 0.25, knn)
    assert kernels.LAUNCHES["match_pairs"] == 1
    want = matching.match_pairs_plain(t, 0.25, knn, chunk=4)
    assert int(want.valid.sum()) > 1000
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_k1_general_form_past_its_shared_memory(cuda):
    t = _one_line_tables(cuda)
    S = t.mask.shape[1]
    got = matching.match_pairs_cuda(t, 0.25, S)
    want = matching.match_pairs_plain(t, 0.25, S, chunk=1)
    assert int(want.valid.sum(-1).max()) > 1024
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("knn,list_len", [(40, 1), (40, 8), (700, 2),
                                           (700, 16)])
def test_k1_general_form_overflow_path(cuda, monkeypatch, knn, list_len):
    """Lists shorter than the rows (``matching.LIST_LEN`` set to
    ``list_len``) send rows past them to the overflow path (a warp per
    flagged row): the same bits as the plain version."""
    inp = synthetic_step_inputs(seed=1, V=6, S=700, N=4, n_lines=600)
    inp["pair_valid"][2, 1] = False
    t = _tables(inp, cuda)
    kernels.reset_launches()
    monkeypatch.setattr(matching, "LIST_LEN", list_len)
    got = matching.match_pairs_cuda(t, 0.25, knn)
    assert kernels.LAUNCHES["match_pairs"] == 1
    want = matching.match_pairs_plain(t, 0.25, knn, chunk=4)
    rows = want.valid.sum(-1)
    assert int((rows > list_len).sum()) > 100
    assert int((rows <= list_len).sum()) > 100
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("records,shape", [
    (1, dict(V=2, S=8, N=4, k=300)), (40, dict(V=2, S=8, N=4, k=300)),
    (2255, dict(V=1, S=3, N=3, k=1000)), (16, dict(V=2, S=6, N=4, k=10))])
def test_k2_general_form_overflow_path(cuda, monkeypatch, records, shape):
    """Segments with more valid slots than the records
    (``scoring.RECORDS`` set to ``records``) take the overflow path (their
    records in a global scratch): the same bits as with room for every
    slot, as without the pre-test, and as the plain version."""
    args, knn = _k2_case(cuda, **shape)
    kw = dict(knn=knn, two_sig_a_sqr=200.0, min_similarity=0.5)
    counts = args[9].sum(-1)
    assert int((counts > records).sum()) > 0
    assert int(((counts > 0) & (counts <= records)).sum()) > 0
    monkeypatch.setattr(scoring, "RECORDS", 6144)
    roomy = scoring.score_matches_cuda(*args, **kw)
    monkeypatch.setattr(scoring, "RECORDS", records)
    got = scoring.score_matches_cuda(*args, **kw)
    every = scoring.score_matches_cuda(*args, pretest=False, **kw)
    want = scoring.score_matches_plain(*args, chunk=64, **kw)
    for other in (roomy, every, want):
        assert torch.equal(got.score3d, other.score3d)
        assert torch.equal(got.valid, other.valid)
    assert int((got.score3d > 0).sum()) > 50


@pytest.mark.parametrize("knn", [1, 10, 16])
def test_k1_keeps_the_prefix(cuda, knn):
    """The kernel at k (a top-k list) and at k = S (every match, rows past
    ``LIST_LEN`` through the overflow path): the first k slots agree bit
    for bit."""
    t, _, _ = _crafted_tables(cuda)
    S = t.mask.shape[1]
    top = matching.match_pairs_cuda(t, 0.25, knn)
    every = matching.match_pairs_cuda(t, 0.25, S)
    assert int(every.valid.sum(-1).max()) > matching.LIST_LEN
    for name in top._fields:
        assert torch.equal(getattr(top, name),
                           getattr(every, name)[..., :knn]), name


def test_k1_cuda_rejects_k_beyond_s(cuda):
    t = _tables(synthetic_step_inputs(seed=2, V=3, S=40, N=2), cuda)
    with pytest.raises(ValueError, match="knn"):
        matching.match_pairs_cuda(t, 0.25, 41)


@pytest.mark.parametrize("shape", [dict(V=2, S=8, N=4, k=300),
                                   dict(V=1, S=3, N=3, k=1000)])
def test_k2_general_form_beyond_1024(cuda, shape):
    """M > 1024, past the cells' M = 160: against its own exact path (no
    pre-test) bit for bit, and the plain version; one launch a call."""
    args, knn = _k2_case(cuda, **shape)
    kernels.reset_launches()
    got = _k2_against_exact_path_and_plain(
        args, dict(knn=knn, two_sig_a_sqr=200.0, min_similarity=0.5))
    assert kernels.LAUNCHES["score_matches"] == 2
    assert int((got.score3d > 0).sum()) > 50


def test_forward_step_cuda_all_matches(cuda):
    """knn = S through the step on the card (K1 and K2 once each, M = 4 *
    64 = 256), the same outputs as the CPU's up to transcendental
    rounding."""
    inp = synthetic_step_inputs(seed=3, V=6, S=64, N=4)
    kw = dict(STEP_KW, knn=64)
    kernels.reset_launches()
    got = step.forward_step(
        *(torch.from_numpy(inp[n]).to(cuda) for n in STEP_ARRAYS), **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["match_pairs"] == 1
    assert kernels.LAUNCHES["score_matches"] == 1
    want = step.forward_step(
        *(torch.from_numpy(inp[n]) for n in STEP_ARRAYS), **kw)
    for name in ("tgt_seg", "match_valid", "kept", "est_valid", "aff_valid"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    for name in ("score3d", "est_P1", "est_P2", "est_d1", "est_d2",
                 "aff_weight", "median_depth"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=1e-4,
                                   atol=1e-4)


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
