"""The collinearity kernel (``csrc/collinearity.cu`` behind
``collinearity.collinear_edges_cuda``) against the plain path
(``collinearity.collinear_edges_plain``) on the same card.  Marked
``gpu``; each test skips where there is no CUDA device.

On a machine with a card and without JAX (the root conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_collinearity_cuda.py

No tolerance: the kernel computes the plain path's float32 functions in
their order, so its edges (view, s1, s2) are the plain path's, in the same
order, and its weights the same bits.  Held on:

* the 26 cached views under the reference's options (``perform_rdd``,
  ``collinearity_t`` = 2, as ``tests/data/torch_features_jax_reference.npz``
  stores them): ``collinear_edges``' inputs captured from one pipeline run
  on the card;
* the seeded broken-line views and estimates of ``test_torch_scenes`` at
  S in {1, 2, TILE - 1, TILE, TILE + 1, 3000} (at 3000 every row a
  segment, over 24 row and column tiles), with a view all masked out,
  ``med_scene_depth`` 0 and 7.5 and ``t_px`` 1, 2 and 4.

Each call launches once by the counter and two calls give the same bits;
arguments the kernel does not take raise before any launch; the card's
``expf`` gives ``torch.exp``'s bits on every float32 argument.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from line3dpp_tpu_torch.ops import collinearity, kernels

from test_torch_scenes import broken_line_views, similarity_inputs

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = os.path.join(REPO, "tests", "data",
                        "torch_features_jax_reference.npz")
TILE = collinearity.TILE
SIZES = [1, 2, TILE - 1, TILE, TILE + 1, 3000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want) -> None:
    """Identical keys in identical order, bit-equal weights."""
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert got[3].dtype == want[3].dtype == np.float32
    np.testing.assert_array_equal(got[3].view(np.int32),
                                  want[3].view(np.int32))


def _seeded(S: int, seed: int, dev, med_scene: float, t_px: float):
    """The arguments of ``collinear_edges`` on 3 seeded views of S
    segments, view 1 masked out; past 160 segments every row is a segment,
    so that eligible pairs fill every row and column tile."""
    rng = np.random.default_rng(seed)
    segs, mask = broken_line_views(rng, V=3, S=max(S, 160), fill=S > 160)
    segs = np.ascontiguousarray(segs[:, :S])
    mask = np.ascontiguousarray(mask[:, :S])
    mask[1] = False
    P1, P2, d1, d2, valid, _, k_reg, med = similarity_inputs(rng, V=3, S=S)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    return (t(segs), t(mask), t(P1), t(P2), t(d1), t(d2), t(valid),
            t(k_reg), t(med), med_scene, t_px, 0.5)


@pytest.fixture(scope="module")
def captured():
    """``collinear_edges``' arguments from one pipeline run of the 26
    cached views under the reference's options, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.utils.testdata import load_views

    with np.load(FEATURES) as data:
        ids = [int(i) for i in data["reference_views"]]
        kw = json.loads(str(data["reference_config"]))
    calls = []
    orig = collinearity.collinear_edges

    def wrapped(*args, **fkw):
        calls.append((args, fkw))
        return orig(*args, **fkw)

    collinearity.collinear_edges = wrapped
    try:
        pipe = lt.Line3D(lt.Config(**kw), device="cuda")
        for v in load_views(ids):
            pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width,
                                              v.height), v.segments)
        pipe.match_images()
        pipe.reconstruct_3d_lines()
    finally:
        collinearity.collinear_edges = orig
    assert len(calls) == 1
    args, fkw = calls[0]
    assert not fkw and args[0].shape == (len(ids), 3000, 4)
    return args


def test_scene_edges_equal_the_plain_path(captured):
    got = collinearity.collinear_edges_cuda(*captured)
    want = collinearity.collinear_edges_plain(*captured)
    assert len(want[0]) > 0
    _same(got, want)
    assert (got[1] < got[2]).all()


def test_scene_through_the_dispatcher_launches_once(captured):
    before = kernels.LAUNCHES["collinear_edges"]
    first = collinearity.collinear_edges(*captured)
    assert kernels.LAUNCHES["collinear_edges"] == before + 1
    second = collinearity.collinear_edges(*captured)
    assert kernels.LAUNCHES["collinear_edges"] == before + 2
    _same(first, second)


@pytest.mark.parametrize("t_px", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("med_scene", [0.0, 7.5])
@pytest.mark.parametrize("S", SIZES)
def test_seeded_edges_equal_the_plain_path(cuda, S, med_scene, t_px):
    args = _seeded(S, 11 + S, cuda, med_scene, t_px)
    got = collinearity.collinear_edges_cuda(*args)
    want = collinearity.collinear_edges_plain(*args)
    _same(got, want)
    if S > TILE and t_px >= 2.0:
        assert len(want[0]) > 0
    if S > 160 and t_px >= 2.0:
        assert len(np.unique(want[1] // TILE)) > 1      # many row tiles
    assert not (got[0] == 1).any()          # the masked-out view


def test_no_views_and_no_segments(cuda):
    """No edges and no launch, as the plain path gives none."""
    before = kernels.LAUNCHES["collinear_edges"]
    for V, S in ((0, 5), (3, 0)):
        z = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=cuda)
        args = (z(V, S, 4), z(V, S, dtype=torch.bool), z(V, S, 3),
                z(V, S, 3), z(V, S), z(V, S), z(V, S, dtype=torch.bool),
                z(V), z(V), 0.0, 2.0, 0.5)
        want = collinearity.collinear_edges_plain(*args)
        assert len(want[0]) == 0
        _same(collinearity.collinear_edges_cuda(*args), want)
    assert kernels.LAUNCHES["collinear_edges"] == before


def _bad_arguments(args):
    """Argument lists the kernel does not take, each with one fault."""
    args = list(args)
    out = []
    for i, bad in ((0, args[0].double()), (1, args[1].to(torch.uint8)),
                   (2, args[2].transpose(0, 1).contiguous().transpose(0, 1)),
                   (4, args[4][:, :-1]), (7, args[7].cpu()),
                   (8, args[8][None])):
        a = list(args)
        a[i] = bad
        out.append(a)
    return out


def test_bad_arguments_raise_before_any_launch(cuda):
    args = _seeded(TILE + 1, 3, cuda, 7.5, 2.0)
    before = kernels.LAUNCHES["collinear_edges"]
    for bad in _bad_arguments(args):
        with pytest.raises(ValueError):
            collinearity.collinear_edges(*bad)
    assert kernels.LAUNCHES["collinear_edges"] == before


def test_expf_gives_torch_exp_bits(cuda):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.expf_differences(cuda) == (0, -1)
