"""What ``l3dbench.run`` and its reference import: no ``jax`` and no
``line3dpp_tpu`` anywhere (top-level names compared whole), and nothing
of ``line3dpp_tpu_torch`` in the reference."""

import ast
import json
import os
import subprocess
import sys

from l3dbench import registry

HERE = registry.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "line3dpp_tpu"}


def loaded(code: str) -> set:
    """Top-level names of every module loaded by ``code`` in a fresh
    interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_and_everything_it_reads_load_no_jax():
    metrics = "; ".join(
        f"registry.metric({m['name']!r})"
        for m in registry.benchmark()["per_layer"])
    code = ("from l3dbench import run, program, reference_run, calibrate, "
            "registry, compare, trace, drive\n"
            "from l3dbench.scenes import testdata, synth_scale, "
            "step_workload\n"
            f"{metrics}\n"
            "[registry.kernel_count(k) for k in ('K1', 'K2', 'K3')]")
    names = loaded(code)
    assert "line3dpp_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import l3dbench.reference_run\n"
                   "from l3dbench.reference import bundle, options, recon, "
                   "scene, step")
    assert not names & (FORBIDDEN | {"line3dpp_tpu_torch"})


def test_no_source_of_the_reference_names_the_program():
    ref = os.path.join(HERE, "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                assert top not in FORBIDDEN | {"line3dpp_tpu_torch"}, (f, m)
