"""The port's LSD options ``side_split``, ``seed_center``, ``seed_gate`` and
``rect_improve`` against the JAX package's, on the CPU, on the images of
``tests/test_lsd.py`` and ``tests/test_lsd_fit.py``.

The JAX side runs as it runs on a TPU (``use_pallas_cc=True``, the Pallas
kernels in interpret mode), which is the path the port follows.  With each
option: the same number of segments, each at rtol 1e-3 / atol 0.1 of JAX's
(the tolerance of ``tests/test_torch_lsd.py``), and the same ``n_split``.
On those images ``side_split`` never finds a hollow band (``n_split`` 0 in
both packages), so one more case runs it on facade view 4 at 384 x 288,
where 8 fused pairs split in both packages and all 78 segments agree.
"""

import numpy as np
import pytest
import torch

from line3dpp_tpu_torch.ops import lsd
from line3dpp_tpu_torch.utils import synthetic

from test_torch_lsd_cases import one_torch_thread  # noqa: F401
from test_torch_lsd_options import _assert_same_segments, _jax_core, \
    _pair_image, _rescue_image, _three_image


def _facade_small():
    quads, _ = synthetic.build_scene()
    cam = synthetic.make_cameras(10, width=384, height=288)[4]
    return synthetic.render(cam, quads, seed=104, ss=1).astype(np.float32)


@pytest.mark.parametrize("opt,image,n_split", [
    ("side_split", _pair_image, 0), ("side_split", _facade_small, 8),
    ("seed_center", _three_image, 0), ("seed_gate", _three_image, 0),
    ("rect_improve", _rescue_image, 0)],
    ids=["side_split-pair", "side_split-facade", "seed_center-three",
         "seed_gate-three", "rect_improve-noise"])
def test_lsd_option_matches_jax(opt, image, n_split):
    img = image()
    segs, ok, st = lsd._lsd_core(torch.from_numpy(img), **{opt: True})
    want, d = _jax_core(img, **{opt: True})
    assert st["n_split"] == d["n_split"] == n_split
    _assert_same_segments(segs[ok].numpy(), want)


def test_side_split_leaves_separated_pair_alone():
    """The pair is two components already: the hollow-band trigger stays
    silent and both long segments come out as without the option."""
    t = torch.from_numpy(_pair_image())
    outs = {}
    for on in (False, True):
        segs, ok, st = lsd._lsd_core(t, side_split=on)
        s = segs[ok].numpy()
        outs[on] = np.sort(s[np.hypot(s[:, 2] - s[:, 0],
                                      s[:, 3] - s[:, 1]) > 60], axis=0)
    assert st["n_split"] == 0
    assert len(outs[True]) == len(outs[False]) == 2
    np.testing.assert_allclose(outs[True], outs[False], atol=1e-3)


def test_detect_accepts_every_option():
    img = _three_image()
    stats = []
    base = lsd.detect_batch([img], device="cpu", stats=stats)[0]
    assert stats[0]["n_rescue"] == 0 and len(base) >= 3
    for opt in ("rescue", "seed_gate", "seed_center", "side_split"):
        segs = lsd.detect(img, device="cpu", **{opt: True})
        assert segs.shape[1] == 4 and len(segs) >= 3, opt
    both = lsd.detect_batch([img], rescue=True, rect_improve=True,
                            seed_gate=True, side_split=True, device="cpu")[0]
    assert len(both) >= 3
