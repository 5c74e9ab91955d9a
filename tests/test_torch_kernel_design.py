"""What kernels K1, K2, K4, K7-K11 assume of the Python around them, on
the CPU.

- K4 (``csrc/lsd_cc.cu``) labels patches of ``lsd_cc.cc_patch(tile)`` in
  shared memory: the patch must divide every tile the detector picks.
- K1 (``csrc/matching.cu``) reads a (V, S, 4) float4 table of the targets
  that ``matching.pair_tables`` builds, and rejects most candidates by a
  pre-test on approximate quotients.  ``matching.pretest_keeps_plain`` is
  that pre-test in torch; here every candidate the exact test accepts must
  pass it with each quotient moved by the stated error bound
  (``PRETEST_REL_ERR``) either way, also against the tightest cut.
- K2 (``csrc/scoring.cu``) rejects most slot pairs by a pre-test on the
  dot product of the two directions and the squared depth differences
  against thresholds widened by a proven margin
  (``scoring.pretest_thresholds``); ``scoring.pretest_keeps_plain`` is that
  pre-test in torch, and here it keeps every pair whose plain similarity
  passes, with its inputs moved by the error bounds either way, at the cut
  itself and under the switches.
- K11 (``csrc/lsd_fit.cu``) reads each component's run from its first
  position: ``lsd._pixel_list`` returns that table (``starts``), and
  ``lsd_fit.run_starts`` builds it from a slot list, after
  ``lsd_fit.check_runs`` has found each component in one run.
- K7 and K8 (``csrc/lsd_fit.cu`` ``fit_kernel``) read the same table: a
  block owns the runs whose heads lie in its stretch of tiles and reads a
  run that goes on past the stretch to its end.  ``lsd_fit.moments_split``
  is that split of the work; here every pixel of every real run is summed
  exactly once, by the block of its run's head, no dump pixel is, every
  pixel is gated once and every component's row written once, on lists
  with short, tile-sized, long and empty components and dump pixels
  anywhere, for several block counts.
- K10 (``csrc/lsd_fit.cu`` ``counts_kernel``) counts in one launch: a
  warp counts its own span only and posts the piece of a run that leaves
  it; the warp where the run ends sums the pieces back to the run's head,
  which it finds in the same table.  ``count_split`` below is that split,
  lane by lane; here every component's row is written once, where its run
  ends, every posted piece is summed once and no warp waits on a piece
  nobody posts, and the rows it assembles are the plain counts, on the
  K7/K8 lists and several span lengths.
- K9's consume form (``csrc/lsd_fit.cu`` ``gate_kernel<true>``) compacts
  the survivors in one pass: each block ranks one tile's survivors by warp
  ballots and a prefix over the warps, and finds the tile's offset by
  decoupled look-back over the earlier tiles' status words.
  ``compact_split`` below is that split; here every survivor is written
  once, at its place in list order, and the count is right, for empty
  lists, lists below one tile and of whole tiles, all survivors or none,
  several tile shapes and any mix of posted prefixes.
- K1 (``csrc/matching.cu`` ``match_list_kernel``) keeps each source's
  matches in a bounded sorted list: ``topk_split`` below builds the rows
  from such lists (the top-k prune for k <= L, every key and the overflow
  flag for k > L, the flagged rows from the overflow path); here they
  equal the plain matcher's for k in {1, 10, 17, 20, 64, S} (10: the
  cells' k) and two list lengths, and exactly the rows longer than the
  list are flagged.
- K2 (``csrc/scoring.cu`` ``score_segment``) lists a segment's valid
  slots from 16-byte chunks of its validity row, ranks them by a block
  prefix and compacts those that pass the gate in place:
  ``setup_split`` below is that walk thread by thread; here every slot's
  zeros are written once with aligned 16-byte stores, every valid slot is
  set up once, in ascending order, the records are the passing slots in
  order, and the overflow is taken exactly where the count passes the
  records, on empty rows, whole chunks, ragged rows and rows around the
  records, at four alignments.
- The collinearity kernel (``csrc/collinearity.cu``) visits the upper
  triangle of every view's pairs in tiles of ``collinearity.TILE``: the
  grid's x decoded row tile by row tile, one (view, row, column tile)
  piece per thread and block, each column tile compacted to its eligible
  segments (masked in, with an estimate) in order.  ``collinear_split``
  below is a Python model of that split and its two passes (the card
  tests, ``test_torch_collinearity_cuda.py``, hold the kernel itself to
  the plain path's edges and order); here every pair i < j of two
  eligible segments is visited exactly once and no other pair, every
  piece's count is written once (the diagonal block writes the zeros left
  of it), and the write pass, at the ends that
  ``collinearity.piece_ends`` (the wrapper's scan) gives, places the edges
  in ``np.nonzero`` order, for several S, V, tile sizes and
  eligibilities.  Its
  pre-test (``chip_smoke.collinear_pretest_keeps``, in place of the four
  divisions) keeps every pair the exact test keeps: at t = 1, 2 and 4, at
  each pair's own cut (the least float above its distances) with t moved
  by 2^-22 either way, and on degenerate, huge, NaN and subnormal inputs.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from line3dpp_tpu_torch.ops import collinearity, lsd, lsd_cc, lsd_fit, \
    matching, scoring

from test_torch_lsd_cases import lines_image, random_sorted_case, \
    random_tables
from test_torch_scenes import agreeing_scoring_case, broken_line_views, \
    bundled_step_inputs, k2_arguments, k2_scene_arguments, pair_list, \
    synthetic_step_inputs

EPS = matching.EPS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cc_patch_divides_every_detector_tile():
    sizes = sorted({*range(64, 8193, 61), 64, 127, 128, 129, 1024, 2304,
                    3072, 8192})
    tiles = set()
    for H in sizes:
        for W in sizes[::7] + [H]:
            _, _, th, tw, hp, wp = lsd._statics(H, W)
            ph, pw = lsd_cc.cc_patch((th, tw))
            assert (ph, pw) == (min(th, 32), 128)
            assert th % ph == 0 and tw % pw == 0
            assert hp % th == 0 and wp % tw == 0
            tiles.add((th, tw))
    # every height and width _tile_for can return
    assert {th for th, _ in tiles} == {8, 16, 32, 64, 128, 256}
    assert {tw for _, tw in tiles} == {128, 256, 512, 1024}


def test_cc_patch_rejects_a_tile_it_does_not_divide():
    with pytest.raises(ValueError, match="patch"):
        lsd_cc.cc_patch((8, 192))
    with pytest.raises(ValueError, match="patch"):
        lsd_cc.cc_patch((48, 128))


def _tables(inp):
    src, tgt, F, pv = pair_list(inp)
    return matching.pair_tables(*(torch.from_numpy(a) for a in (
        inp["segments"], inp["seg_mask"], inp["RtKinv"], inp["C"], src, tgt,
        F, pv)))


def test_pair_tables_target_table_holds_its_fields():
    inp = synthetic_step_inputs(seed=3, V=5, S=64, n_lines=40)
    inp["seg_mask"][2, 5:9] = False
    t = _tables(inp)
    seg, m = t.segments, t.mask
    assert t.tq.shape == seg.shape and t.tq.dtype == torch.float32
    assert t.tq.is_contiguous()
    assert torch.equal(t.tq[m][:, 0:2], seg[m][:, 0:2])
    assert torch.equal(t.tq[m][:, 2], seg[m][:, 2] - seg[m][:, 0])
    assert torch.equal(t.tq[m][:, 3], seg[m][:, 3] - seg[m][:, 1])
    assert not t.tq[~m].any()
    assert (~m).sum() >= 4


def _candidates(t, eo):
    """Per valid pair: the exact parameters t1, t2 of every candidate the
    exact test accepts with overlap > eo (as ops/matching.py evaluates
    them), their overlaps, and every candidate's t1, t2 with the count of
    those the exact interval test keeps."""
    acc_t1, acc_t2, acc_ov, all_t1, all_t2 = [], [], [], [], []
    n_cross = 0
    for p in torch.nonzero(t.pair_valid)[:, 0].tolist():
        s, g = int(t.src_idx[p]), int(t.tgt_idx[p])
        q = t.tq[g][None]                                  # (1, S, 4)
        e1, e2 = t.e1[p][:, None], t.e2[p][:, None]        # (S, 1, 3)
        a1 = e1[..., 0] * q[..., 0] + e1[..., 1] * q[..., 1] + e1[..., 2]
        b1 = e1[..., 0] * q[..., 2] + e1[..., 1] * q[..., 3]
        a2 = e2[..., 0] * q[..., 0] + e2[..., 1] * q[..., 1] + e2[..., 2]
        b2 = e2[..., 0] * q[..., 2] + e2[..., 1] * q[..., 3]
        live = (t.mask[s][:, None] & t.mask[g][None]
                & (b1.abs() > EPS) & (b2.abs() > EPS))
        t1, t2 = -a1[live] / b1[live], -a2[live] / b2[live]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        outer = hi.clamp_min(1.0) - lo.clamp_max(0.0)
        inner = hi.clamp_max(1.0) - lo.clamp_min(0.0)
        cross = (inner >= -EPS) & (outer * t.seglen[g][None].expand_as(
            live)[live] >= 1.0)
        ov = inner / outer.clamp_min(EPS)
        ok = cross & (ov > eo)
        acc_t1.append(t1[ok])
        acc_t2.append(t2[ok])
        acc_ov.append(ov[ok])
        all_t1.append(t1)
        all_t2.append(t2)
        n_cross += int(cross.sum())
    cat = torch.cat
    return (cat(acc_t1), cat(acc_t2), cat(acc_ov), cat(all_t1),
            cat(all_t2), n_cross)


def _moved(x, sign, rel):
    return (x.double() * (1.0 + sign * rel)).float()


def _scene(name):
    if name == "bundled":
        return bundled_step_inputs([0, 1, 2], max_line_segments=300,
                                   num_neighbors=2)
    return synthetic_step_inputs(seed=int(name[-1]), V=6, S=400, N=4,
                                 n_lines=350)


@pytest.mark.parametrize("scene", ["synthetic0", "synthetic1", "bundled"])
def test_k1_pretest_keeps_every_exact_match(scene):
    """Each quotient moved by PRETEST_REL_ERR (and 32 times that) in both
    directions; the cut is epipolar_overlap and, stricter, the largest
    float below the candidate's own overlap (the k-th best at its
    tightest).  No candidate the exact test accepts may be rejected."""
    eo = 0.25
    t1, t2, ov, _, _, _ = _candidates(_tables(_scene(scene)), eo)
    assert ov.numel() > 500
    tight = torch.nextafter(ov, torch.zeros_like(ov))
    for rel in (matching.PRETEST_REL_ERR, 32 * matching.PRETEST_REL_ERR):
        for s1 in (-1.0, 1.0):
            for s2 in (-1.0, 1.0):
                u1, u2 = _moved(t1, s1, rel), _moved(t2, s2, rel)
                for cut in (torch.tensor(eo), tight):
                    assert bool(matching.pretest_keeps_plain(u1, u2,
                                                             cut).all())


def test_k1_pretest_keeps_exact_matches_at_the_boundaries():
    """Intervals ending exactly at 0 and 1, overlaps exactly at the cut,
    and quotients near zero, subnormal and huge."""
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    cases = [  # t1, t2, cut with inner / outer > cut exactly
        (f(0.0), f(1.0), 0.999), (f(-1e-13), f(0.5), 0.25),
        (f(1.0), f(2.0), 0.0), (f(0.0), f(0.0), 0.0),
        (f(-3.0), f(1.0), 0.2499999), (f(1e-40), f(0.75), 0.7499),
        (f(-1e30), f(1e30), 0.0), (f(0.25), f(1.0), 0.7499999)]
    for t1, t2, cut in cases:
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        inner = hi.clamp_max(1.0) - lo.clamp_min(0.0)
        outer = hi.clamp_min(1.0) - lo.clamp_max(0.0)
        if not bool(inner / outer.clamp_min(EPS) > cut):
            continue
        for s1 in (-1.0, 1.0):
            for s2 in (-1.0, 1.0):
                u1 = _moved(t1, s1, matching.PRETEST_REL_ERR)
                u2 = _moved(t2, s2, matching.PRETEST_REL_ERR)
                assert bool(matching.pretest_keeps_plain(u1, u2, cut)), \
                    (t1, t2, cut)
    # a candidate whose interval misses [0, 1] by far is rejected
    assert not bool(matching.pretest_keeps_plain(f(1.5), f(3.0), 0.25))
    assert not bool(matching.pretest_keeps_plain(f(-2.0), f(-0.5), 0.0))


def test_k1_pretest_rejects_nearly_all_that_miss():
    """The margin is not so wide that the pre-test stops rejecting: on 3
    bundled views it keeps at most 5% more candidates than cross their
    target segment."""
    inp = _scene("bundled")
    _, _, _, t1, t2, n_cross = _candidates(_tables(inp), 0.25)
    keeps = int(matching.pretest_keeps_plain(t1, t2, 0.25).sum())
    assert keeps <= 1.05 * n_cross
    assert keeps < 0.2 * t1.numel()


# ---------------------------------------------------------------------------
# K2: the pre-test
# ---------------------------------------------------------------------------

TSA, MS = 200.0, 0.5   # Config(): two_sig_a_sqr = 2 * 10^2, min_similarity


def _pairs(args, knn):
    """Over all valid pairs (m, j) of different groups: the pre-test's
    inputs (dot, e1, e2, den1, den2) and the plain similarity, in the plain
    version's float32 expressions."""
    r1, r2, rmid, C, k_reg, tC, tk, d1, d2, valid = args
    V, S, M = d1.shape
    flat = lambda x: x.reshape(V * S, *x.shape[2:])
    vv = torch.arange(V).repeat_interleave(S)
    dirc, ok, den1, den2 = scoring._slot_geometry(
        flat(r1), flat(r2), flat(rmid), flat(d1), flat(d2), flat(valid),
        C[vv], k_reg[vv], tC[vv], tk[vv], knn=knn, check_orientation=True)
    group = torch.arange(M) // knn
    pair = ok[:, :, None] & ok[:, None, :] & (group[:, None] != group)
    b, m, j = torch.nonzero(pair, as_tuple=True)
    dot = sum(dirc[i][b, m] * dirc[i][b, j] for i in range(3))
    D1, D2 = flat(d1), flat(d2)
    e1, e2 = D1[b, m] - D1[b, j], D2[b, m] - D2[b, j]
    den1, den2 = den1[b, m, 0], den2[b, m, 0]
    return dot, e1, e2, den1, den2


def _plain_sim(dot, e1, e2, den1, den2, tsa=TSA):
    """min(sim_a, sim_p) as ops/scoring.py:_score_chunk evaluates it."""
    ang = torch.acos(dot.clamp(-1.0, 1.0)) * scoring.DEG
    ang = torch.where(ang > 90.0, 180.0 - ang, ang)
    t = torch.tensor(tsa, dtype=torch.float32)
    sim_a = torch.exp(-ang * ang / t)
    sim_p = torch.minimum(torch.exp(-e1 * e1 / den1),
                          torch.exp(-e2 * e2 / den2))
    return torch.minimum(sim_a, sim_p)


def _k2_scene(name):
    if name == "agreeing":
        case, k = agreeing_scoring_case(np.random.default_rng(5), V=4, S=40)
        return k2_arguments(case), k
    if name == "bundled":
        inp = bundled_step_inputs([0, 1, 2, 3, 4], max_line_segments=300,
                                  num_neighbors=4)
        return k2_scene_arguments(inp, 6), 6
    inp = synthetic_step_inputs(seed=int(name[-1]), V=6, S=300, N=4,
                                n_lines=250)
    return k2_scene_arguments(inp, 6), 6


def _moved(x, sign, rel=None, abs_=None):
    x = x.double()
    x = x * (1.0 + sign * rel) if rel is not None else x + sign * abs_
    return x.float()


@pytest.mark.parametrize("scene", ["synthetic1", "synthetic2", "agreeing",
                                   "bundled"])
def test_k2_pretest_keeps_every_passing_pair(scene):
    """The dot product moved by 2^-21 (the bound between the pre-test's
    and the exact path's dot), the depth differences and regularisers by
    2^-22 of their size, each either way: no pair whose plain similarity
    passes min_similarity may be rejected."""
    args, knn = _k2_scene(scene)
    dot, e1, e2, den1, den2 = _pairs(args, knn)
    passing = _plain_sim(dot, e1, e2, den1, den2) > MS
    assert int(passing.sum()) > 200
    dot, e1, e2, den1, den2 = (x[passing] for x in (dot, e1, e2, den1, den2))
    for s in (-1.0, 1.0):
        for t in (-1.0, 1.0):
            keeps = scoring.pretest_keeps_plain(
                _moved(dot, s, abs_=2.0**-21), _moved(e1, t, rel=2.0**-22),
                _moved(e2, t, rel=2.0**-22), _moved(den1, -t, rel=2.0**-22),
                _moved(den2, -t, rel=2.0**-22), TSA, MS)
            assert bool(keeps.all())


def _float_neighbours(x: float, count: int):
    """``count`` float32 values on each side of float32(x), in order."""
    f = torch.tensor(x, dtype=torch.float32)
    lo, hi, out = f, f, [f]
    for _ in range(count):
        lo = torch.nextafter(lo, torch.tensor(-np.inf))
        hi = torch.nextafter(hi, torch.tensor(np.inf))
        out = [lo] + out + [hi]
    return torch.stack(out)


def test_k2_pretest_keeps_pairs_at_the_cut():
    """Depth differences and angles whose plain similarity lands exactly on
    min_similarity and one float above it: the pre-test keeps both (the
    first fails the exact test, the margin keeps it all the same)."""
    ms = torch.tensor(MS, dtype=torch.float32)
    above = torch.nextafter(ms, torch.tensor(1.0))
    one = torch.ones(())
    found = {"depth": set(), "angle": set()}
    # depth: den 1 and 3.7, e near sqrt(den ln 2)
    for den in (1.0, 3.7):
        e = _float_neighbours(float(np.sqrt(den * np.log(2.0))), 4000)
        d = torch.full_like(e, den)
        sim = _plain_sim(one.expand_as(e), e, torch.zeros_like(e), d, d)
        for target in (ms, above):
            at = sim == target
            if at.any():
                found["depth"].add(float(target))
                assert bool(scoring.pretest_keeps_plain(
                    one.expand_as(e[at]), e[at], torch.zeros_like(e[at]),
                    d[at], d[at], TSA, MS).all())
    # angle: a dot near cos(theta*), on both sides of 90 degrees, and
    # two_sig_a_sqr moved float by float until sim_a lands on the cut
    c = float(np.cos(np.radians(np.sqrt(TSA * np.log(2.0)))))
    tsa = _float_neighbours(TSA, 4000)
    for sign in (1.0, -1.0):
        dot = torch.tensor(sign * c, dtype=torch.float32)
        ang = torch.acos(dot) * scoring.DEG
        ang = torch.where(ang > 90.0, 180.0 - ang, ang)
        sim = torch.exp(-ang * ang / tsa)
        for target in (ms, above):
            for t in tsa[sim == target].tolist():
                found["angle"].add(float(target))
                assert bool(scoring.pretest_keeps_plain(
                    dot, torch.zeros(()), torch.zeros(()), one, one, t, MS))
    assert found["depth"] == found["angle"] == {float(ms), float(above)}


def test_k2_pretest_switches():
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    dot, e, den = f(0.0, 0.01, 0.99), f(0.0, 50.0, 0.0), f(1.0, 1.0, 1.0)
    keeps = lambda tsa, ms: scoring.pretest_keeps_plain(dot, e, e, den, den,
                                                        tsa, ms).tolist()
    # min_similarity <= 0: every pair survives
    assert keeps(TSA, 0.0) == keeps(TSA, -0.5) == [True] * 3
    assert scoring.pretest_thresholds(TSA, 0.0) == (-1.0, float("inf"))
    # min_similarity >= 1: none can pass
    assert keeps(TSA, 1.0) == keeps(TSA, 1.5) == [False] * 3
    # theta* >= 90 degrees: no angle test, the depth test stays
    assert scoring.pretest_thresholds(1e6, MS)[0] == -1.0
    assert keeps(1e6, MS) == [True, False, True]
    # the defaults: orthogonal and far pairs go, a close one stays
    assert keeps(TSA, MS) == [False, False, True]


def test_k2_pretest_rejects_nearly_all_that_fail():
    """The margin is not so wide that the pre-test stops rejecting: on the
    synthetic scene it keeps at most 1.2 times the pairs that pass, and
    rejects most pairs."""
    args, knn = _k2_scene("synthetic1")
    dot, e1, e2, den1, den2 = _pairs(args, knn)
    passing = int((_plain_sim(dot, e1, e2, den1, den2) > MS).sum())
    keeps = int(scoring.pretest_keeps_plain(dot, e1, e2, den1, den2, TSA,
                                            MS).sum())
    assert passing <= keeps <= 1.2 * passing
    assert keeps < 0.5 * dot.numel()


def test_k2_pretest_counts_agree_with_the_pairs():
    """chip_smoke.pretest_counts (what the turns script and chip_smoke.py
    report) counts the same pairs and survivors as the pair list, and each
    test's keeps as the pre-test with the other test's input neutral."""
    args, knn = _k2_scene("synthetic2")
    dot, e1, e2, den1, den2 = _pairs(args, knn)
    n = _chip_smoke().pretest_counts(*args, knn=knn, two_sig_a_sqr=TSA,
                                     min_similarity=MS, chunk=97)
    keeps = lambda *x: int(scoring.pretest_keeps_plain(*x, TSA, MS).sum())
    assert n["pairs"] == dot.numel()
    assert n["survivors"] == keeps(dot, e1, e2, den1, den2)
    assert n["angle_keeps"] == int((dot.abs() >= scoring.pretest_thresholds(
        TSA, MS)[0]).sum())
    assert n["depth_keeps"] == keeps(torch.ones_like(dot), e1, e2, den1,
                                     den2)
    assert n["survivors"] <= min(n["angle_keeps"], n["depth_keeps"])
    assert n["warp_steps_survivor"] <= n["warp_steps"] <= n["pairs"]
    assert n["partner_steps_survivor"] <= n["partner_steps"] <= n["pairs"]
    assert n["segments_no_valid"] < n["segments"]


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ---------------------------------------------------------------------------
# K11: the run table
# ---------------------------------------------------------------------------

def _heads(slot, C):
    """First position of each component's run, n where it has none."""
    n = len(slot)
    out = np.full(C, n, np.int64)
    for i in range(n - 1, -1, -1):
        if 0 <= slot[i] < C and (i == 0 or slot[i - 1] != slot[i]):
            out[slot[i]] = i
    # an empty component takes the next start
    for c in range(C - 2, -1, -1):
        out[c] = min(out[c], out[c + 1])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_run_starts_are_the_run_heads(seed):
    """Random sorted slot lists with whole runs dumped between components,
    as tests/test_lsd_fit.py makes them: 256 slots, 40 runs, so most
    components are empty."""
    rng = np.random.default_rng(seed)
    slot = random_sorted_case(rng, n=int(rng.integers(50, 3000)))[0]
    starts = lsd_fit.run_starts(torch.from_numpy(slot), 256)
    assert starts.dtype == torch.int32 and starts.shape == (256,)
    assert np.array_equal(starts.numpy(), _heads(slot, 256))
    # run c lies in [starts[c], starts[c + 1])
    bounds = np.append(starts.numpy(), len(slot))
    for c in np.unique(slot[slot < 256]):
        where = np.nonzero(slot == c)[0]
        assert bounds[c] == where[0] and where[-1] < bounds[c + 1]


def test_run_starts_edges():
    z = torch.zeros(0, dtype=torch.int32)
    assert lsd_fit.run_starts(z, 0).shape == (0,)
    assert lsd_fit.run_starts(z, 3).tolist() == [0, 0, 0]
    assert lsd_fit.run_starts(torch.tensor([0, 0, 0], dtype=torch.int32),
                              0).shape == (0,)
    # a component at the end of the list, dump before and between
    slot = torch.tensor([2, 2, 0, 0, 0, 2, 1, 1, 1], dtype=torch.int32)
    assert lsd_fit.run_starts(slot, 2).tolist() == [2, 6]
    # the last component empty, then the first
    assert lsd_fit.run_starts(slot[:5], 2).tolist() == [2, 5]
    assert lsd_fit.run_starts(slot[6:], 2).tolist() == [0, 0]


@pytest.mark.parametrize("seed", range(2))
def test_check_runs_takes_whole_runs_and_refuses_split_ones(seed):
    """lsd_fit.check_runs, which K11's wrapper runs when it builds the run
    table: the random sorted lists pass; a component split by dump pixels
    or by another component is refused, naming it."""
    rng = np.random.default_rng(seed)
    slot = random_sorted_case(rng, n=int(rng.integers(50, 3000)))[0]
    lsd_fit.check_runs(torch.from_numpy(slot), 256)
    lsd_fit.check_runs(torch.zeros(0, dtype=torch.int32), 3)
    c = int(slot[slot < 256][0])
    where = np.nonzero(slot == c)[0]
    split = np.concatenate([slot[:where[-1] + 1], [256], [c], slot[
        where[-1] + 1:]]).astype(np.int32)
    with pytest.raises(ValueError, match=f"component {c} has 2 runs"):
        lsd_fit.check_runs(torch.from_numpy(split), 256)
    for order in ([0, 1, 0], [1, 0, 0, 2, 1, 1]):
        with pytest.raises(ValueError, match="has 2 runs"):
            lsd_fit.check_runs(torch.tensor(order, dtype=torch.int32), 2)


def test_pixel_list_returns_the_run_table():
    """On a small detection's round-1 list: every component's first
    position, equal to run_starts of its slots."""
    img, _ = lsd._prepare(lines_image(), -1, torch.device("cpu"))
    _, _, th, tw, _, _ = lsd._statics(*img.shape)
    pl = lsd._pixel_list(*lsd._grad_compact(img), lsd.PREC, (th, tw))
    slot, C = pl["slot"].numpy(), pl["C"]
    assert C > 3 and (slot == C).any()
    assert pl["starts"].dtype == torch.int32
    assert np.array_equal(pl["starts"].numpy(), _heads(slot, C))
    assert torch.equal(pl["starts"], lsd_fit.run_starts(pl["slot"], C))
    lsd_fit.check_runs(pl["slot"], C)


# ---------------------------------------------------------------------------
# K7 and K8: the split of the work over the runs
# ---------------------------------------------------------------------------

SPAN = lsd_fit.FIT_THREADS * lsd_fit.FIT_ITEMS


def _runs(lengths, dump, tail, C=None):
    """A slot list of runs of the given lengths (0: a component with no
    pixel), ``dump[c]`` dump pixels before run c and ``tail`` after the
    last; the dump slot is ``C``."""
    C = len(lengths) if C is None else C
    slot = []
    for c, (m, d) in enumerate(zip(lengths, dump)):
        slot += [C] * int(d) + [c] * int(m)
    return np.array(slot + [C] * tail, np.int32), C


def _split_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "short":
        m = rng.integers(5, 70, 2000)
        return _runs(m, rng.integers(0, 6, 2000) * (rng.uniform(size=2000)
                                                     < 0.5), 3)
    if name == "tile_sized":
        m = [SPAN + d for d in (-1, 0, 1)] + [3, 4, 5, 127, 128, 129, 31,
                                              32, 33, SPAN // 2]
        return _runs(m, rng.integers(0, 3, len(m)), 2)
    if name == "long":
        return _runs([7208, 5, 3 * SPAN + 7, 20000, 9000],
                     [SPAN - 3, 0, 11, 1, SPAN], 5)
    if name == "empty":
        return _runs([0, 40, 0, 0, 2 * SPAN + 3, 7, 0, 6, 0],
                     [2, 0, 3, 0, 1, 0, 0, 9, 0], 0)
    if name == "dump_only":
        return _runs([], [], 1500, C=0)
    if name == "no_dump":
        return _runs(rng.integers(1, 3 * SPAN, 12), [0] * 12, 0)
    if name == "random_sorted":
        return random_sorted_case(rng, n=5000)[0], 256
    raise ValueError(name)


SPLIT_CASES = ["short", "tile_sized", "long", "empty", "dump_only",
               "no_dump", "random_sorted"]


@pytest.mark.parametrize("layout", [(lsd_fit.FIT_THREADS, None),
                                    (lsd_fit.FIT_THREADS_LONG, 3), (32, 1),
                                    (32, 7), (64, 5)],
                         ids=lambda v: f"{v[0]}threads-{v[1]}blocks")
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_k7_k8_split_sums_every_run_pixel_once(name, layout):
    """Each pixel of a real run is added once, to its component, by the
    block whose stretch of tiles holds the run's head (past the stretch: in
    that block's read of the rest); no dump pixel is added; K8 gates every
    pixel once; every row is written once, by the head's block or, for a
    component with no pixel, by the blocks past the stretches."""
    slot, C = _split_case(name)
    threads, blocks = layout
    span = threads * lsd_fit.FIT_ITEMS
    t = torch.from_numpy(slot)
    starts = lsd_fit.run_starts(t, C)
    lsd_fit.check_runs(t, C)
    split = lsd_fit.moments_split(t, C, starts, threads, blocks)
    n = len(slot)
    real = torch.from_numpy((slot >= 0) & (slot < C))
    assert torch.equal(split["sums"], real.long())
    assert torch.equal(split["gates"], torch.ones(n, dtype=torch.long))
    # the stretches: whole tiles, as even as the tiles allow
    tiles = -(-n // span)
    nb = tiles if blocks is None else min(blocks, tiles)
    c1 = [min((b + 1) * tiles // nb * span, n) for b in range(nb)]
    block_of = torch.searchsorted(torch.tensor(c1), torch.arange(n),
                                  right=True)
    # the owner is the block of the run's head, which adds the pixels in
    # its stretch and those it reads past it, each in the thread of its
    # place in its tile
    head_block = torch.full((n,), -1, dtype=torch.long)
    head_block[real] = block_of[starts.long()[t.long()[real]]]
    pos = torch.arange(n)
    assert torch.equal(split["block"], head_block)
    assert torch.equal(split["rest"], real & (block_of != head_block))
    assert torch.equal(split["thread"][real],
                       pos[real] % span // lsd_fit.FIT_ITEMS)
    assert (split["thread"][real] < threads).all()
    assert torch.equal(split["writes"], torch.ones(C, dtype=torch.long))
    nxt = torch.cat([starts.long(), torch.tensor([n])])
    empty = starts.long() >= nxt[1:]
    assert (split["writer"][empty] == -1).all()
    assert torch.equal(split["writer"][~empty],
                       block_of[starts.long()[~empty]])
    if name == "long" and nb > 1:
        # runs several tiles long are finished by their head's block
        assert int(split["rest"].sum()) > span
    if name == "empty":
        assert int(empty.sum()) == 5
    if name == "short":
        assert n % span != 0
        assert bool(split["rest"].any()) == (nb > 1)


def test_k7_k8_layout_follows_the_run_length():
    """Lists whose components average 512 pixels or more (the facade's
    round 1: 45,347 pixels, 12 components) take the wide blocks; lists of
    short runs (real photos' density) the narrow ones; the split's default
    follows the same rule."""
    assert lsd_fit.fit_threads(45347, 12) == lsd_fit.FIT_THREADS_LONG
    assert lsd_fit.fit_threads(2801668, 60360) == lsd_fit.FIT_THREADS
    assert lsd_fit.fit_threads(512 * 7, 7) == lsd_fit.FIT_THREADS_LONG
    assert lsd_fit.fit_threads(512 * 7 - 1, 7) == lsd_fit.FIT_THREADS
    assert lsd_fit.fit_threads(100, 0) == lsd_fit.FIT_THREADS_LONG
    slot, C = _split_case("long")
    split = lsd_fit.moments_split(torch.from_numpy(slot), C)
    span = lsd_fit.FIT_THREADS_LONG * lsd_fit.FIT_ITEMS
    assert int(split["thread"].max()) == lsd_fit.FIT_THREADS_LONG - 1
    # the last component's pixels go to the block of its head
    head = int(lsd_fit.run_starts(torch.from_numpy(slot), C)[-1])
    assert int(split["block"].max()) == head // span


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_k7_k8_rows_are_the_sums_over_the_run_table(name):
    """Each row of ``moments`` and ``gate_moments`` (with ``starts`` given,
    as the detector calls them; on the CPU the plain versions, which equal
    the calls without it) is the float64 sum of the float32 terms over the
    pixels of that component in its run ``[starts[c], starts[c + 1])`` of
    the table, rounded once; column 7 and the rows of components with no
    pixel are 0."""
    slot, C = _split_case(name)
    rng = np.random.default_rng(len(slot))
    n = len(slot)
    xs = rng.integers(0, 2560, n).astype(np.float32)
    ys = rng.integers(0, 1920, n).astype(np.float32)
    mag = rng.uniform(5.0, 200.0, n).astype(np.float32)
    pix = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tables, ang = random_tables(rng, C, n)
    t = [torch.from_numpy(v) for v in (slot, xs, ys, mag, pix, tables, ang)]
    slot_t, xs_t, ys_t, mag_t, pix_t, tab_t, ang_t = t
    starts = lsd_fit.run_starts(slot_t, C)
    nxt = np.append(starts.numpy().astype(np.int64), n)

    def by_run(p):
        terms = lsd_fit._moment_terms(xs_t, ys_t, mag_t, p).double().numpy()
        want = np.zeros((C, 8), np.float32)
        for c in range(C):
            lo, hi = nxt[c], nxt[c + 1]
            own = slot[lo:hi] == c
            want[c, :7] = terms[lo:hi][own].sum(0)
        return torch.from_numpy(want)

    got = lsd_fit.moments(slot_t, xs_t, ys_t, mag_t, pix_t, C, starts)
    assert torch.equal(got, lsd_fit.moments(slot_t, xs_t, ys_t, mag_t,
                                            pix_t, C))
    torch.testing.assert_close(got, by_run(pix_t), rtol=1e-6, atol=0)
    assert got.shape == (C, 8) and not got[:, 7].any()
    args = (slot_t, xs_t, ys_t, ang_t, mag_t, pix_t, tab_t, True,
            lsd.COS_GATE, C)
    np8, mom8 = lsd_fit.gate_moments(*args, starts=starts)
    np8_b, mom8_b = lsd_fit.gate_moments(*args)
    assert torch.equal(np8, np8_b) and torch.equal(mom8, mom8_b)
    torch.testing.assert_close(mom8, by_run(np8), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K10: the split of the counting over the runs
# ---------------------------------------------------------------------------

# the pixels a lane of kernel K10 counts in its short layout
K10_ITEMS = lsd_fit.COUNT_SPAN_SHORT // 32


def count_split(slot, C: int, starts, items: int, hits=None) -> dict:
    """The split of the work in kernel K10 (``counts_kernel`` in
    ``csrc/lsd_fit.cu``) over a slot list whose components are runs.

    Warp g counts the span ``[32 items g, 32 items (g + 1))``, lane l its
    ``items`` consecutive pixels from ``32 items g + items l``, and nothing
    else.  A lane writes the row of a run that begins and ends in it, of
    its first run where that ends in it, and of its last run where the next
    lane's (lane 31: the next span's) first pixel is another's.  The warp
    whose span a run leaves posts the run's piece (its pixels in the span);
    the warp where a run begun in an earlier span ends sums the pieces of
    the spans from the run's head (``starts[c] // span``) to its own.

    Returns per span ``posted`` and ``summed`` (how often its piece is
    summed), per component ``writes`` (how often its row is written) and
    ``writer`` (the span whose lane writes it, -1 for the blocks past the
    pixel blocks, which write the rows of the components with no pixel),
    and ``unposted_reads`` (pieces summed that no warp posts: a wait
    forever on the card).  With ``hits`` (per pixel, the columns it adds),
    also ``counts``: each row as the kernel assembles it."""
    slot = np.asarray(slot, np.int64)
    n = len(slot)
    starts = np.asarray(starts, np.int64)
    nxt = np.append(starts, n)
    span = 32 * items
    real = (slot >= 0) & (slot < C)
    spans = -(-n // span)
    posted = np.zeros(spans, bool)
    summed = np.zeros(spans, np.int64)
    writes = np.zeros(C, np.int64)
    writer = np.full(C, -1, np.int64)
    cols = 0 if hits is None else hits.shape[1]
    counts = np.zeros((C, cols), np.int64)
    unposted = 0

    def piece(c, g):
        lo, hi = g * span, min((g + 1) * span, n)
        own = np.nonzero(slot[lo:hi] == c)[0] + lo
        return hits[own].sum(0) if hits is not None else 0

    sums = []
    for g in range(spans):
        w0, hi = g * span, min((g + 1) * span, n)
        key = np.full(span, -1, np.int64)
        key[:hi - w0] = np.where(real[w0:hi], slot[w0:hi], -1)
        after = slot[hi] if hi < n else -1
        if key[hi - w0 - 1] >= 0 and after == key[hi - w0 - 1]:
            posted[g] = True
        head = key[0]
        if head >= 0 and w0 > 0 and slot[w0 - 1] == head and not (
                (key == head).all() and after == head):
            sums.append((head, starts[head] // span, g))
        lanes = key.reshape(32, items)
        for l in range(32):
            k = lanes[l]
            cuts = [0] + [j for j in range(1, items) if k[j] != k[j - 1]]
            pieces = [k[j] for j in cuts]
            ended = [kk for kk in pieces[1:-1] if kk >= 0]
            if len(pieces) > 1 and pieces[0] >= 0:
                ended.append(pieces[0])
            nxt_key = lanes[l + 1][0] if l < 31 else after
            if pieces[-1] >= 0 and nxt_key != pieces[-1]:
                ended.append(pieces[-1])
            for kk in ended:
                writes[kk] += 1
                writer[kk] = g
                if hits is not None:
                    counts[kk] += piece(kk, g)
    for c, g0, g in sums:
        for j in range(g0, g):
            summed[j] += 1
            unposted += not posted[j]
            if hits is not None:
                counts[c] += piece(c, j)
    for c in range(C):
        if nxt[c] >= nxt[c + 1]:
            writes[c] += 1                  # no pixel
    return dict(posted=posted, summed=summed, writes=writes, writer=writer,
                unposted_reads=unposted, counts=counts)


@pytest.mark.parametrize("items", [K10_ITEMS, 8, 12],
                         ids=lambda v: f"{v}items")
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_k10_split_writes_every_row_once(name, items):
    """Each component's row is written once, by the warp of the span where
    its run ends (a component with no pixel past the pixel blocks); every
    piece a warp posts is summed once, by that warp, and no warp waits on
    a piece that no warp posts; a run of thousands of pixels (the
    facade's) is posted by every span it leaves."""
    slot, C = _split_case(name)
    t = torch.from_numpy(slot)
    lsd_fit.check_runs(t, C)
    starts = lsd_fit.run_starts(t, C).numpy().astype(np.int64)
    split = count_split(slot, C, starts, items)
    assert np.array_equal(split["writes"], np.ones(C, np.int64))
    assert split["unposted_reads"] == 0
    assert np.array_equal(split["summed"], split["posted"].astype(np.int64))
    n, span = len(slot), 32 * items
    nxt = np.append(starts, n)
    empty = starts >= nxt[1:]
    assert (split["writer"][empty] == -1).all()
    for c in np.nonzero(~empty)[0]:
        last = np.nonzero(slot == c)[0][-1]
        assert split["writer"][c] == last // span
    if name == "long":
        assert split["posted"].sum() > 7208 // span


@pytest.mark.parametrize("items", [K10_ITEMS, 8])
@pytest.mark.parametrize("name", ["random_sorted", "long", "empty"])
def test_k10_split_counts_as_the_plain_version(name, items):
    """The rows the split assembles (each lane's pieces and the pieces
    summed from the posted words) equal ``rescue_counts_plain``: a split
    that dropped or doubled a pixel would not."""
    slot, C = _split_case(name)
    rng = np.random.default_rng(len(slot))
    n = len(slot)
    tables, ang = random_tables(rng, C, n)
    tables[:, 4] = rng.uniform(-3, 3, C)
    tables[:, 5] = rng.uniform(0.5, 12.0, C)
    row = tables[np.minimum(slot, C - 1)]
    along, across = rng.uniform(-60, 60, n), rng.uniform(-8, 8, n)
    xs = np.rint(row[:, 2] + along * row[:, 0] - across * row[:, 1]
                 ).astype(np.float32)
    ys = np.rint(row[:, 3] + along * row[:, 1] + across * row[:, 0]
                 ).astype(np.float32)
    pix = (rng.uniform(size=n) < 0.9).astype(np.float32)
    t = [torch.from_numpy(v) for v in (slot, xs, ys, ang, pix, tables)]
    want = lsd_fit.rescue_counts_plain(*t, C, lsd.RESCUE_BANDS,
                                       lsd.COS_GATE_HALF)
    starts = lsd_fit.run_starts(t[0], C).numpy()
    split = count_split(slot, C, starts, items, _pixel_hits(t, C))
    assert np.array_equal(split["counts"], want.numpy().astype(np.int64))
    assert want.sum() > 0


def _pixel_hits(t, C):
    """Each pixel's 16 columns (the p/2 retry, then the 15 bands) as the
    plain versions decide them, (n, 16)."""
    slot, xs, ys, ang, pix, tables = t
    bands = torch.tensor(lsd.RESCUE_BANDS)
    row, valid = lsd_fit._rows(slot, tables, C)
    ct, st, cx, cy, mid, width = row[:, :6].unbind(1)
    w_proj = -(xs - cx) * st + (ys - cy) * ct
    s = (2.0 * (w_proj - mid))[:, None]
    lo = bands[None, :, 0] * width[:, None] + bands[None, :, 1]
    hi = bands[None, :, 2] * width[:, None] + bands[None, :, 3]
    live = ((pix != 0.0) & valid)[:, None]
    band = live & (s >= lo) & (s <= hi)
    half = tables.clone()
    half[:, 4] = torch.where(tables[:, 5] > 0, 0.5 * tables[:, 5], -1.0)
    half[:, 5] = tables[:, 4]
    p2 = lsd_fit.gate_pixels_plain(slot, xs, ys, ang, pix, half, False,
                                   lsd.COS_GATE_HALF, C) != 0.0
    return torch.cat([p2[:, None], band], 1).numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# K9's consume form: the tiles and the look-back of the compaction
# ---------------------------------------------------------------------------

# the SMs of an H100, on which the layout rule was measured
H100_SMS = 132


def compact_split(alive: torch.Tensor,
                  threads: int = lsd_fit.CONSUME_THREADS,
                  items: int | None = None, posted=None) -> dict:
    """The split of the work in the consume form of kernel K9
    (``gate_kernel<true>`` in ``csrc/lsd_fit.cu``) over a list whose
    survivors are ``alive``.

    A block compacts one tile of ``threads * items`` pixels (``items``:
    ``lsd_fit.consume_items`` on an H100's SMs when None); warp w of the
    tile holds its pixels
    ``32 * items * w ..``, item q of lane l the warp's pixel ``32 q + l``.
    Each warp ballots its survivors item by item, the warps' counts are
    prefixed in shared memory, and the tile
    finds its offset by decoupled look-back: it posts its count at once,
    then reads the words of the tiles before it, 32 at a time from the
    nearest, and sums them back to the nearest word that holds an
    inclusive prefix.  ``posted`` (bool per tile, tile 0 always true) says
    which tiles had posted their inclusive prefix when the later tiles read
    their words; the others show their count only.  None: a seeded random
    mix.

    Returns, per pixel: ``rank`` (its place in the output, -1 for a
    consumed pixel), ``tile``, ``warp``, ``item``, ``lane``; per tile:
    ``aggregate`` (its survivors), ``prefix`` (the look-back's sum) and
    ``reads`` (status words read); and ``count``, the survivors the last
    tile writes."""
    alive = alive.bool().cpu()
    n = alive.numel()
    items = lsd_fit.consume_items(n, H100_SMS) if items is None else items
    span = threads * items
    tiles = -(-n // span)
    warps = threads // 32
    a = torch.zeros(tiles * span, dtype=torch.bool)
    a[:n] = alive
    a = a.reshape(tiles, warps, items, 32).long()
    # the ranks inside the warp: earlier items, then earlier lanes
    per_item = a.sum(3)
    in_warp = (per_item.cumsum(2) - per_item)[..., None] + a.cumsum(3) - a
    per_warp = per_item.sum(2)
    warp_off = per_warp.cumsum(1) - per_warp
    aggregate = per_warp.sum(1)
    if posted is None:
        g = torch.Generator().manual_seed(tiles)
        posted = torch.rand(tiles, generator=g) < 0.5
    posted = torch.as_tensor(posted, dtype=torch.bool).clone()
    if tiles:
        posted[0] = True
    prefix = torch.zeros(tiles, dtype=torch.long)
    reads = torch.zeros(tiles, dtype=torch.long)
    for t in range(1, tiles):
        total, k = 0, t - 1
        while True:
            window = torch.arange(k, k - 32, -1)
            window = window[window >= 0]
            reads[t] += window.numel()
            word = torch.where(posted[window], prefix[window]
                               + aggregate[window], aggregate[window])
            hit = torch.nonzero(posted[window])
            if hit.numel():
                total += int(word[:int(hit[0, 0]) + 1].sum())
                break
            total += int(word.sum())
            k -= 32
        prefix[t] = total
    rank = (prefix[:, None, None, None] + warp_off[:, :, None, None]
            + in_warp).reshape(-1)[:n]
    pos = torch.arange(n)
    return dict(rank=torch.where(alive, rank, -1), tile=pos // span,
                warp=pos % span // (32 * items),
                item=pos % (32 * items) // 32, lane=pos % 32,
                aggregate=aggregate, prefix=prefix, reads=reads,
                count=int(prefix[-1] + aggregate[-1]) if tiles else 0)


def _alive_case(name, tile):
    rng = np.random.default_rng(sum(map(ord, name)) + tile)
    n = {"empty": 0, "below_tile": tile - 37, "one_tile": tile,
         "whole_tiles": 5 * tile, "ragged": 3 * tile + 5,
         "many_tiles": 70 * tile + 11}.get(name, 4 * tile + 9)
    if name == "all_alive":         # a list of dump pixels only
        return torch.ones(n, dtype=torch.bool)
    if name == "none_alive":
        return torch.zeros(n, dtype=torch.bool)
    # runs of consumed pixels (accepted components) between survivors
    return torch.from_numpy(np.repeat(rng.uniform(size=n // 7 + 1) < 0.6,
                                      7)[:n].copy())


ALIVE_CASES = ["empty", "below_tile", "one_tile", "whole_tiles", "ragged",
               "many_tiles", "all_alive", "none_alive"]


@pytest.mark.parametrize("layout", [(lsd_fit.CONSUME_THREADS,
                                     lsd_fit.CONSUME_ITEMS_LONG),
                                    (lsd_fit.CONSUME_THREADS,
                                     lsd_fit.CONSUME_ITEMS_SHORT), (32, 1),
                                    (64, 3)],
                         ids=lambda v: f"{v[0]}threads-{v[1]}items")
@pytest.mark.parametrize("posted", ["random", "all", "first_only"])
@pytest.mark.parametrize("name", ALIVE_CASES)
def test_k9_consume_split_writes_each_survivor_once_in_order(name, posted,
                                                             layout):
    """Every survivor gets one place, its rank in list order, no consumed
    pixel gets one, and the count the last tile writes is the number of
    survivors, whichever tiles had posted their inclusive prefix when the
    later ones looked back; a tile reads at most its predecessors' words,
    32 at a time back to the nearest posted one."""
    threads, items = layout
    tile = threads * items
    alive = _alive_case(name, tile)
    n = alive.numel()
    tiles = -(-n // tile)
    flags = {"random": None, "all": torch.ones(tiles, dtype=torch.bool),
             "first_only": torch.zeros(tiles, dtype=torch.bool)}[posted]
    split = compact_split(alive, threads, items, flags)
    rank = split["rank"]
    k = int(alive.sum())
    assert split["count"] == k
    assert torch.equal(rank[alive], torch.arange(k))
    assert (rank[~alive] == -1).all()
    # the pixel's place in its tile: warp-major, then item, then lane
    pos = torch.arange(n)
    assert torch.equal(split["tile"] * tile + split["warp"] * 32 * items
                       + split["item"] * 32 + split["lane"], pos)
    assert (split["warp"] < threads // 32).all()
    agg = split["aggregate"]
    assert torch.equal(split["prefix"], agg.cumsum(0) - agg)
    t = torch.arange(tiles)
    if posted == "all":
        assert torch.equal(split["reads"], t.clamp(max=32))
    if posted == "first_only":
        assert torch.equal(split["reads"], t)
    assert (split["reads"] <= t).all()
    if name == "many_tiles" and posted == "first_only":
        assert int(split["reads"].max()) > 32


@pytest.mark.parametrize("seed", range(3))
def test_k9_consume_split_places_the_plain_survivors(seed):
    """The consume form's ranks, applied to the detector-like list of
    ``random_sorted_case`` gated by the plain consume gate, give
    ``consume_survivors``' output (the plain version, on the CPU)."""
    rng = np.random.default_rng(seed)
    C = 256
    slot, xs, ys, mag, _ = random_sorted_case(rng, n=9000)
    tables, ang = random_tables(rng, C, len(slot))
    idx_s = np.sort(rng.choice(1 << 22, len(slot), replace=False))
    t = [torch.from_numpy(v) for v in (slot, xs, ys, idx_s, mag, ang,
                                       tables)]
    got = lsd_fit.consume_survivors(*t, lsd.COS_GATE, C)
    alive = lsd_fit.gate_pixels(t[0], t[1], t[2], t[5],
                                torch.ones(len(slot)), t[6], False,
                                lsd.COS_GATE, C) == 0.0
    split = compact_split(alive)
    assert split["count"] == got[0].numel() < len(slot)
    for g, src in zip(got, (t[3], t[4], t[5])):
        out = torch.empty(split["count"], dtype=src.dtype)
        out[split["rank"][alive]] = src[alive]
        assert torch.equal(out, g)


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
def test_k9_consume_layout_follows_the_list_length(sms):
    """Lists shorter than one long tile an SM (on an H100 the facade's
    round 1: 45,347 pixels) take short tiles, longer ones (real photos'
    density) long tiles, whatever the card's SM count; the split's default
    follows the same rule on an H100."""
    long_ = sms * lsd_fit.CONSUME_THREADS * lsd_fit.CONSUME_ITEMS_LONG
    short, long_items = lsd_fit.CONSUME_ITEMS_SHORT, lsd_fit.CONSUME_ITEMS_LONG
    assert lsd_fit.consume_items(2801668, sms) == long_items
    assert lsd_fit.consume_items(long_ - 1, sms) == short
    assert lsd_fit.consume_items(long_, sms) == long_items
    assert lsd_fit.consume_items(45347, H100_SMS) == short
    alive = torch.ones(45347, dtype=torch.bool)
    split = compact_split(alive)
    tile = lsd_fit.CONSUME_THREADS * lsd_fit.CONSUME_ITEMS_SHORT
    assert int(split["tile"].max()) == (45347 - 1) // tile
    assert int(split["item"].max()) == lsd_fit.CONSUME_ITEMS_SHORT - 1


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
def test_k10_span_follows_the_list_length(sms):
    """Lists that fill less than one wave of the card in long spans (on an
    H100 the facade's round 1: 45,347 pixels) take short spans, longer ones
    (real photos' density) long spans, whatever the card's SM count; both
    are whole lanes of whole 4-pixel loads, and the split counts in either
    exactly as the plain version (``test_k10_split_*``)."""
    short, long_ = lsd_fit.COUNT_SPAN_SHORT, lsd_fit.COUNT_SPAN_LONG
    wave = (sms * lsd_fit.COUNT_BLOCKS_LONG * lsd_fit.COUNT_THREADS // 32
            * long_)
    assert lsd_fit.count_span(2801668, sms) == long_
    assert lsd_fit.count_span(wave - 1, sms) == short
    assert lsd_fit.count_span(wave, sms) == long_
    assert lsd_fit.count_span(0, sms) == short
    assert lsd_fit.count_span(45347, H100_SMS) == short
    for span in (short, long_):
        assert span % (32 * 4) == 0 and span // 32 in (K10_ITEMS, 8)


# ---- K1: per-thread bounded lists

def _match_key(overlap: float, tc: int) -> int:
    bits = int(np.float32(overlap).view(np.uint32))
    return ((~bits & 0xFFFFFFFF) << 32) | tc


def topk_split(t, eo: float, knn: int, list_len: int) -> dict:
    """K1 (``csrc/matching.cu`` ``match_list_kernel``), row by row: the
    valid candidates in ascending target order, each kept in a list of L =
    min(knn, list_len); knn <= L: the exact top-k, sorted (a candidate
    must beat the k-th overlap, a full list drops its last); knn > L:
    every passing target in target order, a row with more than L flagged,
    and the keys ranked when the row is written.  The flagged rows take
    the overflow path (here: the plain rows).  Returns the assembled
    ``tgt_seg``/``overlap`` (P, S, knn), the flagged rows and each row's
    candidate count."""
    P, S = t.num_src.shape
    L = min(knn, list_len)
    bounded = knn <= L
    every = matching.match_pairs_plain(t, eo, S, chunk=4)
    want = matching.match_pairs_plain(t, eo, knn, chunk=4)
    idx = torch.zeros((P, S, knn), dtype=torch.int32)
    ov = torch.zeros((P, S, knn))
    flagged, counts = [], every.valid.sum(-1)
    tg, ovs, vs = (every.tgt_seg.numpy(), every.overlap.numpy(),
                   every.valid.numpy())
    for p in range(P):
        for s in range(S):
            n = int(counts[p, s])
            order = np.argsort(tg[p, s, :n], kind="stable")
            keys, thr, over = [], np.float32(0.0), False
            for j in order:             # the scan's ascending targets
                tc, o = int(tg[p, s, j]), ovs[p, s, j]
                assert vs[p, s, j] and o > eo
                if not o > thr:
                    continue
                if not bounded:
                    if len(keys) == L:
                        over = True
                        break
                    keys.append(_match_key(o, tc))
                    continue
                key = _match_key(o, tc)
                at = len(keys) if len(keys) < L else L - 1
                while at > 0 and keys[at - 1] > key:
                    at -= 1
                keys = keys[:at] + [key] + keys[at:]
                keys = keys[:L]
                if bounded and len(keys) == L:
                    thr = np.float32(np.uint32(~(keys[-1] >> 32)
                                               & 0xFFFFFFFF).view(
                                                   np.float32))
            if over:
                flagged.append(p * S + s)
                idx[p, s] = want.tgt_seg[p, s]
                ov[p, s] = want.overlap[p, s]
                continue
            # a key's slot: its rank among the row's keys
            ranks = [sum(q < key for q in keys) for key in keys]
            assert bounded or sorted(ranks) == list(range(len(keys)))
            for j, key in zip(ranks, keys):
                idx[p, s, j] = key & 0xFFFFFFFF
                ov[p, s, j] = float(np.uint32(~(key >> 32) & 0xFFFFFFFF)
                                    .view(np.float32))
    return dict(tgt_seg=idx, overlap=ov, flagged=flagged, counts=counts,
                want=want)


def _topk_scene(name):
    if name == "one_line":
        # every segment a copy of one line, half of them exact: rows of
        # ~S matches with exact ties, where the top-k's prune bites
        inp = synthetic_step_inputs(seed=5, V=3, S=90, N=2, n_lines=90)
        segs = inp["segments"]
        noise = np.random.default_rng(5).normal(0.0, 0.3, segs.shape)
        noise[:, ::2] = 0.0
        segs[:] = segs[:, :1] + noise.astype(np.float32)
        inp["seg_mask"][:] = True
        inp["seg_mask"][1, 7] = False
        return inp
    return _scene(name)


@pytest.mark.parametrize("list_len", [4, 32])
@pytest.mark.parametrize("knn", [1, 10, 17, 20, 64, "S"])
@pytest.mark.parametrize("scene", ["synthetic1", "bundled", "one_line"])
def test_k1_topk_split_equals_plain(scene, knn, list_len):
    t = _tables(_topk_scene(scene))
    S = t.mask.shape[1]
    knn = S if knn == "S" else knn
    split = topk_split(t, 0.25, knn, list_len)
    want = split["want"]
    assert torch.equal(split["tgt_seg"], want.tgt_seg)
    assert torch.equal(split["overlap"], want.overlap)
    over = torch.nonzero(split["counts"].reshape(-1) > list_len)[:, 0]
    if knn <= list_len:
        assert split["flagged"] == []
    else:
        assert split["flagged"] == over.tolist()
    if scene == "one_line":
        assert int(split["counts"].max()) > 64
        assert len(over) > 0


# ---- K2: the set-up over 16-byte validity chunks

def setup_split(valid_row: np.ndarray, addr: int, cap: int,
                gate: np.ndarray, threads: int = 128,
                unroll: int = 2) -> dict:
    """K2 (``csrc/scoring.cu`` ``score_segment``) on one row of M bools
    whose first byte lies at ``addr`` (mod 16), thread by thread of its
    block: the zeros of the row's score (4 B) and validity
    (1 B) arrays by ``zero_row``, the valid slots listed by ``list_valid``
    (16 bytes a thread where aligned, a byte a thread at the ends, ranks by
    the block's prefix over the threads' counts, ``unroll`` chunks in
    flight), overflow where the count passes ``cap``, then the set-up of
    the listed slots a slot a thread with those that pass ``gate`` moved
    down in place.  Returns the writes of each slot's zeros, the listed
    count, the set-up calls, the records and whether it overflowed."""
    M = len(valid_row)
    out = dict(zeros_f32=np.zeros(M, int), zeros_u8=np.zeros(M, int),
               setups=[], over=False)

    def zero_row(counts, size):
        per = 16 // size
        head = min(((16 - (addr * size) % 16) % 16) // size, M)
        counts[:head] += 1
        body = (M - head) // per
        for i in range(body):
            assert (addr * size + (head + i * per) * size) % 16 == 0
            counts[head + i * per: head + (i + 1) * per] += 1
        counts[head + body * per:] += 1

    zero_row(out["zeros_f32"], 4)
    zero_row(out["zeros_u8"], 1)
    SL = [None] * cap
    head = min((16 - addr % 16) % 16, M)
    body = (M - head) // 16
    nv = 0

    def step(bits, m0):
        """One block step: thread t's set slots m0[t] + bits[t]."""
        nonlocal nv
        cnt = [len(b) for b in bits]
        for t in range(threads):
            r = nv + sum(cnt[:t])
            for b in bits[t]:
                if r < cap:
                    SL[r] = m0[t] + int(b)
                r += 1
        nv += sum(cnt)

    def byte_step(lo, hi):
        step([[0] if lo + t < hi and valid_row[lo + t] else []
              for t in range(threads)], [lo + t for t in range(threads)])

    byte_step(0, head)
    for c0 in range(0, body, threads * unroll):
        for u in range(unroll):
            chunks = [c0 + u * threads + t for t in range(threads)]
            step([np.flatnonzero(valid_row[head + c * 16:head + c * 16 + 16])
                  if c < body else [] for c in chunks],
                 [head + c * 16 for c in chunks])
    byte_step(head + body * 16, M)
    out["listed"] = nv
    if nv > cap:
        out["over"] = True
        return out
    ng = 0
    for i0 in range(0, nv, threads):
        ms = SL[i0:min(i0 + threads, nv)]  # every thread reads, then writes
        out["setups"] += ms
        ok = [bool(gate[m]) for m in ms]
        for t, m in enumerate(ms):
            if ok[t]:
                r = ng + sum(ok[:t])
                assert r <= i0 + t            # only slots already read
                SL[r] = m
        ng += sum(ok)
    out["records"] = SL[:ng]
    return out


def _setup_row(name, rng):
    M = {"empty": 48, "full_chunks": 64, "ragged": 1000, "sparse": 3000,
         "dense": 777, "one": 5}[name]
    p = {"empty": 0.0, "full_chunks": 1.0, "ragged": 0.1, "sparse": 0.005,
         "dense": 0.6, "one": 0.5}[name]
    return rng.uniform(size=M) < p


@pytest.mark.parametrize("addr", [0, 1, 4, 15])
@pytest.mark.parametrize("cap", [1, 40, 512])
@pytest.mark.parametrize("name", ["empty", "full_chunks", "ragged",
                                  "sparse", "dense", "one"])
def test_k2_setup_split_lists_each_valid_slot_once(name, cap, addr):
    rng = np.random.default_rng(len(name) * 7 + cap + addr)
    row = _setup_row(name, rng)
    gate = rng.uniform(size=len(row)) < 0.7
    split = setup_split(row, addr, cap, gate)
    valid = np.flatnonzero(row)
    assert (split["zeros_f32"] == 1).all() and (split["zeros_u8"] == 1).all()
    assert split["listed"] == len(valid)
    assert split["over"] == (len(valid) > cap)
    if split["over"]:
        assert split["setups"] == []
        return
    assert split["setups"] == valid.tolist()        # once each, ascending
    assert split["records"] == [m for m in valid if gate[m]]


def test_k2_setup_split_rows_across_the_records():
    """Rows with cap - 1, cap and cap + 1 valid slots around the default
    records (``scoring.RECORDS``), at the all-matches block's M."""
    rng = np.random.default_rng(3)
    cap = scoring.RECORDS
    for n in (cap - 1, cap, cap + 1):
        row = np.zeros(48000, bool)
        row[rng.choice(48000, n, replace=False)] = True
        split = setup_split(row, 0, cap, np.ones(48000, bool))
        assert split["over"] == (n > cap) and split["listed"] == n
        if n <= cap:
            assert split["records"] == np.flatnonzero(row).tolist()


# ---------------------------------------------------------------------------
# the collinearity kernel: its tiles, its output order, its pre-test
# ---------------------------------------------------------------------------

def collinear_split(edge: np.ndarray, eligible: np.ndarray,
                    tile: int) -> dict:
    """A model of ``csrc/collinearity.cu``'s schedule, which these tests
    check, not the kernel: its two passes over (V, S, S) ``edge`` (the
    pairs that are edges, all of two ``eligible`` (V, S) segments), block
    by block and row by row: the grid's x decoded to (row tile, column
    tile) as the kernel decodes it, the column tile compacted to its
    eligible segments in order, each eligible row's pairs (against those
    columns, j > i), the count pass's piece counts (the diagonal block
    also writes its rows' zeros left of it), then the write pass at the
    ends of ``collinearity.piece_ends``.  Returns how often each pair was
    visited and each piece's count written, and the (E, 3) edges as
    written."""
    V, S, _ = edge.shape
    T = -(-S // tile)
    blocks = []
    for bx in range(T * (T + 1) // 2):
        b, rt = bx, 0
        while b >= T - rt:
            b -= T - rt
            rt += 1
        blocks.append((rt, rt + b))
    visits = np.zeros((V, S, S), np.int64)
    written = np.zeros((V, S, T), np.int64)
    counts = np.full((V, S, T), -1, np.int64)
    pieces = []                       # (v, i, ct, the columns visited)
    for v in range(V):
        for rt, ct in blocks:
            cols = np.arange(ct * tile, min((ct + 1) * tile, S))
            cols = cols[eligible[v, cols]]           # compacted, in order
            for i in range(rt * tile, min((rt + 1) * tile, S)):
                if ct == rt:
                    counts[v, i, :rt] = 0
                    written[v, i, :rt] += 1
                js = cols[cols > i] if eligible[v, i] else cols[:0]
                visits[v, i, js] += 1
                counts[v, i, ct] = int(edge[v, i, js].sum())
                written[v, i, ct] += 1
                pieces.append((v, i, ct, js))
    ends = collinearity.piece_ends(torch.from_numpy(counts)).numpy()
    out = np.full((int(ends.reshape(-1)[-1]) if ends.size else 0, 3), -1)
    for v, i, ct, js in pieces:              # the write pass, any order
        base = ends[v, i, ct] - counts[v, i, ct]
        for m, j in enumerate(js[edge[v, i, js]]):
            out[base + m] = (v, i, j)
    return dict(visits=visits, written=written, counts=counts, out=out)


def _edge_case(name, V, S, rng):
    """Eligible segments and edges among them."""
    eligible = {"all": np.ones((V, S), bool),
                "none": np.zeros((V, S), bool)}.get(
        name, rng.uniform(size=(V, S)) < 0.6)
    if name == "last":                       # one edge: the last pair
        eligible = np.ones((V, S), bool)
        e = np.zeros((V, S, S), bool)
        if S > 1:
            e[-1, S - 2, S - 1] = True
    elif name == "random":
        e = rng.uniform(size=(V, S, S)) < 0.05
    else:
        e = np.ones((V, S, S), bool)
    return e & eligible[:, :, None] & eligible[:, None, :], eligible


@pytest.mark.parametrize("tile,V,S", [
    (collinearity.TILE, 2, 1), (collinearity.TILE, 1, 2),
    (collinearity.TILE, 2, collinearity.TILE - 1),
    (collinearity.TILE, 1, collinearity.TILE),
    (collinearity.TILE, 2, collinearity.TILE + 1),
    (collinearity.TILE, 1, 300), (4, 3, 1), (4, 2, 4), (4, 3, 13),
    (8, 2, 40), (4, 1, 33)])
@pytest.mark.parametrize("name", ["random", "all", "none", "last"])
def test_collinear_split_visits_the_upper_triangle_once(tile, V, S, name):
    edge, eligible = _edge_case(name, V, S,
                                np.random.default_rng(V * 1000 + S))
    split = collinear_split(edge, eligible, tile)
    upper = np.triu(np.ones((S, S), np.int64), 1)
    both = eligible[:, :, None] & eligible[:, None, :]
    assert (split["visits"] == upper * both).all()   # once, and no other
    assert (split["written"] == 1).all() and (split["counts"] >= 0).all()
    want = np.argwhere(edge & upper.astype(bool))    # np.nonzero's order
    np.testing.assert_array_equal(split["out"].reshape(-1, 3), want)


def test_piece_ends_is_the_row_major_inclusive_scan():
    counts = torch.from_numpy(np.random.default_rng(1).integers(
        0, 5, (3, 7, 2))).to(torch.int64)
    ends = collinearity.piece_ends(counts)
    assert ends.dtype == torch.int64 and ends.shape == counts.shape
    np.testing.assert_array_equal(
        ends.numpy().reshape(-1), np.cumsum(counts.numpy().reshape(-1)))


def _column_distances(segs: torch.Tensor):
    """The plain path's d21 and d22 of every pair (row i, column j): the
    column's endpoints to the row's line."""
    x1, y1, x2, y2 = segs.unbind(-1)
    a = lambda t: t[:, :, None]              # noqa: E731
    b = lambda t: t[:, None, :]              # noqa: E731
    d21 = collinearity._point_line_dist2d(b(x1), b(y1), a(x1), a(y1),
                                          a(x2), a(y2))
    d22 = collinearity._point_line_dist2d(b(x2), b(y2), a(x1), a(y1),
                                          a(x2), a(y2))
    return d21, d22


@pytest.mark.parametrize("t_px", [1.0, 2.0, 4.0])
def test_collinear_pretest_keeps_every_collinear_pair(t_px):
    segs, mask = (torch.from_numpy(x) for x in
                  broken_line_views(np.random.default_rng(3)))
    exact = collinearity.collinear_pairs(segs, mask, t_px)
    keeps = _chip_smoke().collinear_pretest_keeps(segs, mask, t_px)
    assert int(exact.sum()) > 50
    assert not bool((exact & ~keeps).any())


def test_collinear_pretest_keeps_pairs_at_their_own_cut():
    """Each pair's t is the least float above its larger column distance,
    so the exact test keeps it by those two distances; moved down by
    2^-22, eight times the rounding of one product, the pre-test keeps it
    still (its margin is 2^-20), and moved up too."""
    segs, mask = (torch.from_numpy(x) for x in
                  broken_line_views(np.random.default_rng(4)))
    d21, d22 = _column_distances(segs)
    dmax = torch.maximum(d21, d22)
    finite = torch.isfinite(dmax) & mask[:, :, None] & mask[:, None, :]
    t = torch.nextafter(dmax, torch.full_like(dmax, float("inf")))
    assert bool(((d21 < t) & (d22 < t))[finite].all())
    for sign in (-1.0, 1.0):
        moved = (t.double() * (1.0 + sign * 2.0**-22)).float()
        keeps = _chip_smoke().collinear_pretest_keeps(segs, mask, moved)
        assert bool(keeps[finite].all())


def test_collinear_pretest_on_degenerate_inputs():
    """Zero-length and huge segments, a NaN endpoint, thresholds whose
    product with the length is subnormal or zero: wherever the exact test
    keeps a pair, the pre-test keeps it (a NaN threshold keeps all)."""
    f = np.float32
    segs = np.array([[[10, 10, 10, 10], [10, 10, 10, 10], [0, 0, 1e-20, 0],
                      [5e-21, 0, 2e-20, 0], [1e30, 1e30, 3e30, 1e30],
                      [4e30, 1e30, 6e30, 1e30], [0, 0, 100, 0],
                      [101, 1e-30, 200, 0], [np.nan, 0, 5, 5],
                      [-3e38, 0, 3e38, 0], [0, 0, 1e-30, 1e-30]]], f)
    mask = np.ones(segs.shape[:2], bool)
    s, m = torch.from_numpy(segs), torch.from_numpy(mask)
    for t_px in (2.0, 1e-30, 1e-45, 0.0, 3e38):
        exact = collinearity.collinear_pairs(s, m, t_px)
        keeps = _chip_smoke().collinear_pretest_keeps(s, m, t_px)
        assert not bool((exact & ~keeps).any()), t_px
    thr = _chip_smoke().collinear_pretest_threshold(
        torch.tensor([1.0, 0.0, 1e-40]), 1.0)
    assert thr[0] > 1.0 and torch.isinf(thr[1:]).all()


def test_collinear_pretest_rejects_nearly_all_pairs():
    """The pre-test is cheap only if it decides: on the seeded views it
    keeps under 5% of the masked-in pairs, at most 4 times the pairs whose
    two column distances pass."""
    segs, mask = (torch.from_numpy(x) for x in
                  broken_line_views(np.random.default_rng(3)))
    keeps = _chip_smoke().collinear_pretest_keeps(segs, mask, 2.0)
    d21, d22 = _column_distances(segs)
    both = (d21 < 2.0) & (d22 < 2.0) & mask[:, :, None] & mask[:, None, :]
    pairs = int((mask[:, :, None] & mask[:, None, :]).sum())
    assert int(keeps.sum()) < 0.05 * pairs
    assert int(both.sum()) <= int(keeps.sum()) <= 4 * int(both.sum())
