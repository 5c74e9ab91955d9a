"""What kernels K1 and K4 assume of the Python around them, on the CPU.

- K4 (``csrc/lsd_cc.cu``) labels patches of ``lsd_cc.cc_patch(tile)`` in
  shared memory: the patch must divide every tile the detector picks.
- K1 (``csrc/matching.cu``) reads a (V, S, 4) float4 table of the targets
  that ``matching.pair_tables`` builds, and rejects most candidates by a
  pre-test on approximate quotients.  ``matching.pretest_keeps_plain`` is
  that pre-test in torch; here every candidate the exact test accepts must
  pass it with each quotient moved by the stated error bound
  (``PRETEST_REL_ERR``) either way, also against the tightest cut.
"""

import numpy as np
import pytest
import torch

from line3dpp_tpu_torch.ops import lsd, lsd_cc, matching

from test_torch_scenes import bundled_step_inputs, pair_list, \
    synthetic_step_inputs

EPS = matching.EPS


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
