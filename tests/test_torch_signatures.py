"""The port takes the JAX package's arguments: every public function that
both packages define in the same module has the JAX function's positional
parameters, in its order, and accepts each of its keyword names, apart
from the TPU-only parameters listed in ``TPU_ONLY`` with their reasons.

Then the calls that used to differ, each on the CPU: ``detect_batch``
with ``depth`` in its position, ``forward_step`` with
``med_scene_depth_static`` against JAX's (``tests/test_torch_step.py``'s
tolerances), ``normalize`` along another axis against JAX's, and the
Pallas switches of ``forward_step``, ``affinity_dense`` and
``sharded_forward_step`` bit for bit against the calls without them.  And
the packaging: each script of ``pyproject.toml`` imports, and the port's
version is the JAX package's.
"""

import importlib
import inspect
import os
import pkgutil
import tomllib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import line3dpp_tpu
import line3dpp_tpu_torch
from line3dpp_tpu.models import step as jax_step
from line3dpp_tpu.ops import geometry as jax_geo
from line3dpp_tpu_torch.models import step
from line3dpp_tpu_torch.models.pipeline import STEP_ARRAYS
from line3dpp_tpu_torch.ops import affinity, geometry, lsd
from line3dpp_tpu_torch.parallel import run, sharded

from test_torch_lsd_cases import one_torch_thread  # noqa: F401
from test_torch_lsd_options import _rescue_image
from test_torch_scenes import STEP_KW, synthetic_step_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules that both packages have ("" is the package itself)
MODULES = [
    "", "camera", "cli", "cli.run", "config", "io", "io.bundler",
    "io.colmap", "io.mavmap", "io.nvm", "io.openmvg", "io.pix4d",
    "io.types", "models", "models.pipeline", "models.step", "ops",
    "ops.affinity", "ops.bundling", "ops.clustering", "ops.collinearity",
    "ops.fitting", "ops.geometry", "ops.lsd", "ops.lsd_cc", "ops.lsd_fit",
    "ops.lsd_gather", "ops.matching", "ops.rdd", "ops.scoring",
    "ops.sweep", "ops.undistort", "parallel", "parallel.sharded", "utils",
    "utils.debug_draw", "utils.golden", "utils.ref_bin",
    "utils.segments_cache", "utils.writers"]

_INTERPRET = "runs a Pallas kernel in interpret mode, a TPU-only switch"
_C_CAP = ("the static component capacity that sizes the Pallas tables; "
          "the port's C (the component count) takes its place")
_TILE_SHAPES = "a TPU tile or padding shape of the Pallas kernel"

# (module, function) -> ({JAX-only parameter: why}, the port's parameters
# that take their places)
TPU_ONLY = {
    ("ops.affinity", "compact_edges"): (
        {"size": "the jit bucket of the edge list (static shapes)"},
        {"tgt_seg"}),
    ("ops.affinity", "compact_kept"): (
        {"size": "the jit bucket of the kept list (static shapes)"}, set()),
    ("ops.lsd_cc", "cc_tiles"): (
        {"max_iters": "the bound of the Pallas loop's propagation rounds",
         "check_every": "how often the Pallas loop tests convergence",
         "interpret": _INTERPRET}, set()),
    ("ops.lsd_cc", "merge_tile_labels"): (
        {"link_cap": "the static capacity of the border-link table"},
        set()),
    ("ops.lsd_fit", "moments"): (
        {"c_cap": _C_CAP, "interpret": _INTERPRET}, {"C"}),
    ("ops.lsd_fit", "gate_moments"): (
        {"c_cap": _C_CAP, "interpret": _INTERPRET}, {"C"}),
    ("ops.lsd_fit", "gate_pixels"): (
        {"c_cap": _C_CAP, "interpret": _INTERPRET}, {"C"}),
    ("ops.lsd_fit", "band_counts"): (
        {"c_cap": _C_CAP, "interpret": _INTERPRET}, {"C"}),
    ("ops.lsd_fit", "extents"): (
        {"c_cap": _C_CAP, "interpret": _INTERPRET,
         "sb": "the sentinel of the Pallas table's padding rows"}, {"C"}),
    ("ops.lsd_gather", "apply_merge_dense"): (
        {"lab_d": "the label grid padded to whole TPU tiles",
         "tile": _TILE_SHAPES, "invalid": "the padding label of that grid",
         "interpret": _INTERPRET}, {"lab"}),
    ("ops.rdd", "rdd_sparse"): (
        {"nbr": "the degree-padded neighbour table (static shapes); the "
                "port takes the CSR matrix",
         "w": "the degree-padded weights", "rev": "the degree-padded "
                                                  "reverse slots",
         "row_chunk": "the jit chunk of rows"}, {"csr"}),
    ("parallel.sharded", "sharded_forward_step"): (
        {"mesh": "a JAX device mesh; the port takes a torch.distributed "
                 "group"}, {"group"}),
    ("parallel.sharded", "shard_inputs"): (
        {"mesh": "a JAX device mesh; the port takes the rank and the "
                 "world size"}, {"rank", "world"}),
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _public_callables(mod):
    """``(name, callable)`` of the module's public functions, of its
    classes (their constructors) and of their public methods
    (``Class.method``)."""
    for name, fn in vars(mod).items():
        if (name.startswith("_") or not callable(fn)
                or getattr(fn, "__module__", None) != mod.__name__):
            continue
        if not hasattr(fn, "_fields"):
            # a NamedTuple is a result that the package builds
            yield name, fn
        if inspect.isclass(fn):
            for meth, f in vars(fn).items():
                if not meth.startswith("_") and inspect.isfunction(f):
                    yield f"{name}.{meth}", f


def _lookup(mod, dotted):
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
    return obj


def _signature(fn):
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def _module(pkg, rel):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def test_the_module_list_is_every_shared_module():
    def names(pkg):
        return {m.name[len(pkg.__name__) + 1:] for m in
                pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}

    shared = names(line3dpp_tpu) & names(line3dpp_tpu_torch)
    assert set(MODULES) == shared | {""}


@pytest.mark.parametrize("rel", MODULES)
def test_port_takes_the_jax_functions_parameters(rel):
    jax_mod = _module("line3dpp_tpu", rel)
    port_mod = _module("line3dpp_tpu_torch", rel)
    for name, jax_fn in _public_callables(jax_mod):
        fn = _lookup(port_mod, name)
        want = _signature(jax_fn)
        got = None if fn is None else _signature(fn)
        if want is None or got is None:
            continue
        only, standins = TPU_ONLY.get((rel, name), ({}, set()))
        jax_pos = [p.name for p in want.parameters.values()
                   if p.kind in _POSITIONAL and p.name not in only
                   and not p.name.startswith("_")]
        port_pos = [p.name for p in got.parameters.values()
                    if p.kind in _POSITIONAL and p.name not in standins
                    and not p.name.startswith("_")]
        assert port_pos[:len(jax_pos)] == jax_pos, (
            f"{rel}.{name}: positional {port_pos} against JAX's {jax_pos}")
        takes_any = any(p.kind == p.VAR_KEYWORD
                        for p in got.parameters.values())
        missing = [p.name for p in want.parameters.values()
                   if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                   and p.name not in only and not p.name.startswith("_")
                   and p.name not in got.parameters and not takes_any]
        assert not missing, f"{rel}.{name}: no parameter {missing}"
        stale = set(only) - set(want.parameters)
        assert not stale, f"{rel}.{name}: JAX has no {stale}"


def test_every_listed_exception_is_a_shared_function():
    for rel, name in TPU_ONLY:
        assert rel in MODULES
        assert callable(getattr(_module("line3dpp_tpu", rel), name))
        assert callable(getattr(_module("line3dpp_tpu_torch", rel), name))


def test_detect_batch_takes_depth_in_jax_position(monkeypatch):
    """``detect_batch(imgs, -1, 3)`` binds 3 to ``depth`` (it used to
    switch ``rect_improve`` on) and detects what the keyword call does."""
    params = inspect.signature(lsd.detect_batch).parameters
    assert list(params)[:4] == ["images", "max_width", "depth",
                                "rect_improve"]
    for name in ("device", "stats"):
        assert params[name].kind == inspect.Parameter.KEYWORD_ONLY
    core, seen = lsd._lsd_core, []

    def recording_core(img, **kw):
        seen.append(kw["rect_improve"])
        return core(img, **kw)

    monkeypatch.setattr(lsd, "_lsd_core", recording_core)
    img = _rescue_image()
    got = lsd.detect_batch([img], -1, 3, device="cpu")[0]
    want = lsd.detect_batch([img], max_width=-1, depth=3, device="cpu")[0]
    assert seen == [False, False] and len(got) >= 3
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        lsd.detect_batch([img], -1, 2, device="cpu")[0], want)
    lsd.detect_batch([img], -1, 3, True, device="cpu")
    assert seen[-1] is True
    with pytest.raises(ValueError, match="depth"):
        lsd.detect_batch([img], depth=0, device="cpu")


def _step_both(inp, **kw):
    args = [inp[n] for n in STEP_ARRAYS]
    got = step.forward_step(*(torch.from_numpy(a) for a in args), **kw)
    want = jax_step.forward_step(*(jnp.asarray(a) for a in args), **kw)
    return ({n: getattr(got, n).numpy() for n in got._fields},
            {n: np.asarray(getattr(want, n)) for n in want._fields})


@pytest.mark.parametrize("seed", [0, 7])
def test_forward_step_med_scene_depth_static_against_jax(seed):
    """A fixed scene depth below the medians cuts affinity edges in both
    packages alike; the tolerances of tests/test_torch_step.py."""
    inp = synthetic_step_inputs(seed=seed, V=6, S=48, N=4)
    base, _ = _step_both(inp, **STEP_KW)
    x = 0.5 * float(np.median(base["median_depth"]))
    got, want = _step_both(inp, med_scene_depth_static=x, **STEP_KW)
    assert (base["aff_valid"] != want["aff_valid"]).any()
    assert want["aff_valid"].sum() > 10
    for n in ("match_valid", "kept", "est_valid", "aff_valid"):
        np.testing.assert_array_equal(got[n], want[n], n)
    mv = want["match_valid"]
    np.testing.assert_array_equal(got["tgt_seg"][mv], want["tgt_seg"][mv])
    for n in ("score3d", "aff_weight"):
        np.testing.assert_allclose(got[n], want[n], atol=5e-3, err_msg=n)
    for n in ("est_P1", "est_P2", "est_d1", "est_d2", "median_depth"):
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3, atol=1e-4,
                                   err_msg=n)


def test_forward_step_ignores_the_pallas_switches():
    inp = synthetic_step_inputs(seed=3, V=5, S=32, N=3)
    args = [torch.from_numpy(inp[n]) for n in STEP_ARRAYS]
    want = step.forward_step(*args, **STEP_KW)
    got = step.forward_step(*args, use_pallas_matching=True,
                            use_pallas_scoring=True, pallas_interpret=True,
                            **STEP_KW)
    for n in want._fields:
        assert torch.equal(getattr(got, n), getattr(want, n)), n


@pytest.mark.parametrize("shape,axis", [((3, 5), 0), ((2, 3, 4), 1),
                                        ((4, 3), -1), ((2, 4, 5), 1),
                                        ((3, 2, 3), -3)])
def test_normalize_along_an_axis_against_jax(shape, axis):
    v = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    v[0] = 0.0
    got = geometry.normalize(torch.from_numpy(v), axis=axis).numpy()
    want = np.asarray(jax_geo.normalize(jnp.asarray(v), axis=axis))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if shape[axis] == 3 and axis == -1:
        np.testing.assert_array_equal(
            got, geometry.normalize(torch.from_numpy(v)).numpy())


def test_affinity_dense_ignores_the_pallas_switches():
    inp = synthetic_step_inputs(seed=0, V=5, S=32, N=3)
    args = [torch.from_numpy(inp[n]) for n in STEP_ARRAYS]
    msf = step._match_score_filter(
        *args, **{k: v for k, v in STEP_KW.items() if k != "min_affinity"})
    nbr, k_reg = args[STEP_ARRAYS.index("neighbor_ids")], args[
        STEP_ARRAYS.index("k_reg")]
    call = lambda **sw: affinity.affinity_dense(
        msf["fm"], msf["t_seg"], nbr, k_reg, msf["median_depth"], 1.0,
        STEP_KW["two_sig_a_sqr"], STEP_KW["min_affinity"], **sw)
    want = call()
    got = call(use_pallas=True, pallas_interpret=True)
    assert int(want.edge_valid.sum()) > 0
    for n in want._fields:
        assert torch.equal(getattr(got, n), getattr(want, n)), n


def test_sharded_step_takes_the_jax_options():
    """``use_pallas``/``pallas_interpret`` change no bit."""
    # one rank: an in-process store, no socket
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        host = run.example_inputs(V=8, S=16, N=2)
        args = [torch.from_numpy(a) for a in sharded.shard_inputs(0, 1,
                                                                  *host)]
        want = sharded.sharded_forward_step(**run.STATIC)(*args)
        for opts in (dict(use_pallas=True), dict(pallas_interpret=True),
                     dict(use_pallas=True, pallas_interpret=True)):
            got = sharded.sharded_forward_step(**run.STATIC, **opts)(*args)
            for n in want._fields:
                assert torch.equal(getattr(got, n), getattr(want, n)), \
                    (opts, n)
    finally:
        dist.destroy_process_group()


def test_pyproject_scripts_import_and_version():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)["project"]
    scripts = meta["scripts"]
    assert scripts["runLine3Dpp"] == "line3dpp_tpu.cli.run:main"
    assert scripts["runLine3Dpp_torch"] == "line3dpp_tpu_torch.cli.run:main"
    for target in scripts.values():
        mod, func = target.split(":")
        assert callable(getattr(importlib.import_module(mod), func)), target
    assert set(meta["optional-dependencies"]["torch"]) == {"torch", "scipy"}
    assert line3dpp_tpu_torch.__version__ == line3dpp_tpu.__version__
