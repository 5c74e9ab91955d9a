"""The benchmark of ``line3dpp_tpu_torch``: one run of one cell.

    python3 -m l3dbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's inputs from the seed (``l3dbench/scenes``), loads
or builds the program's kernels (into ``build/kernels/`` of the checkout)
and runs one warm-up scene on inputs of its own.  The window then runs
scenes back to back for ``--seconds`` (a closed loop: one user, who starts
the next scene once the last one's lines are on the host).  A scene is a
new ``Line3D`` under the cell's ``Config``, the views added with their
cached segments, ``match_images`` and ``reconstruct_3d_lines``, ended by a
device synchronize.

After the window, the program's outputs of a sample of the window's scenes
(the cell's ``sample`` scenes drawn from the seed evenly over the whole
window, and the window's last scene) are compared with the plain
reference's (``l3dbench/reference``) by the numbers and limits of the
cell's workload file (``compare.py``): the step against the reference's
step on the same inputs, the 3D lines against the reference's
reconstruction from the program's step outputs.  The reference runs once
the peak memory has been read and the program's state freed.

``--trace 0`` prints the cell's end-to-end metrics: ``images_per_s`` (the
views of every scene completed in the window over the time from the
window's start to the end of its last completed scene), ``scene_p90_ms``
(the 90th percentile of those scenes' wall times, in the cells that list
it, left out where the window holds fewer than 100 scenes) and
``setup_s`` (process start to the window's start).  ``--trace 1`` runs
the cell's ``trace_scenes`` scenes under ``torch.profiler`` with a
span and a synchronize around each phase, and prints the per-layer metrics
(``l3dbench/metrics``), the card's busy and window seconds and a
breakdown.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key, ``checks``.

The run exits 2 without a result when the cell's CUDA devices are not
there, and 3 when ``jax``, ``jaxlib``, ``flax`` or ``line3dpp_tpu`` is
loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

from . import registry  # noqa: E402
from .scenes import seed_words  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "line3dpp_tpu")
P90_MIN_SCENES = 100
# build and kernel caches stay in fixed directories of the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m l3dbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def p90(values: list[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             classes=None) -> dict:
    """One run of ``cell`` (as :func:`registry.cell` gives it) on
    ``device``; returns the result object.  ``classes`` replaces the
    program's ``(Line3D, Config, Camera)``, as the tests do."""
    import torch

    from . import compare, drive, reference_run
    from . import trace as trace_mod

    if classes is None:
        from . import program
        classes = program.CLASSES
    spec, config = cell["spec"], cell["config"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    options = dict(spec["options"])
    source = registry.generator(config["generator"]).Source(
        config, spec, seed, dev)
    drive.scene(classes, options, source.scene(-1), dev)
    setup_s = time.perf_counter() - T0

    # the sample: every traced scene; else ``sample`` scenes drawn from the
    # seed, evenly over the whole window (a reservoir), and the window's
    # last scene
    rng = np.random.default_rng(seed_words(seed, 1 << 32))
    reservoir, last = {}, None
    traced = {}
    times, scenes = [], []
    attempted = failed = views_done = 0
    stack = contextlib.ExitStack()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = stack.enter_context(torch.profiler.profile(activities=acts))
        stack.enter_context(torch.profiler.record_function("l3dbench.window"))
    t_start = time.perf_counter()
    last_end = t_start
    index = 0
    while time.perf_counter() - t_start < seconds and not (
            trace and index >= int(spec["trace_scenes"])):
        inputs = source.scene(index)
        attempted += 1
        t0 = time.perf_counter()
        try:
            with (torch.profiler.record_function("l3dbench.scene") if trace
                  else contextlib.nullcontext()):
                pipe, phases = drive.scene(classes, options, inputs, dev,
                                           traced=bool(trace))
        except (RuntimeError, ValueError):
            failed += 1
            traceback.print_exc()
            index += 1
            continue
        t1 = time.perf_counter()
        if t1 - t_start <= seconds:
            times.append(t1 - t0)
            views_done += source.views_per_scene
            last_end = t1
            last = (index, pipe)
            n, k = len(times), int(spec["sample"])
            if len(reservoir) < k:
                reservoir[index] = pipe
            elif rng.random() < k / n:
                del reservoir[sorted(reservoir)[int(rng.integers(k))]]
                reservoir[index] = pipe
        if trace:
            traced[index] = pipe
        scenes.append(dict(index=index, views=source.views_per_scene,
                           phases=phases))
        del pipe
        index += 1
    stack.close()

    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kept = traced if trace else dict(reservoir)
    if last is not None and not trace:
        kept[last[0]] = last[1]
    prog_out = {i: drive.outputs(p) for i, p in kept.items()}
    kept.clear()
    reservoir.clear()
    traced.clear()
    last = None
    tr = trace_mod.Trace.from_profile(prof) if trace else None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    per_scene, counts = [], []
    for i in sorted(prog_out):
        inputs = source.scene(i)
        ref_step, cnt = reference_run.step(options, inputs, dev)
        ref_lines = reference_run.recon(options, inputs,
                                        prog_out[i]["state"], dev)
        per_scene.append(compare.numbers(prog_out[i], ref_step, ref_lines))
        counts.append(cnt)
    correct, checks = compare.judge(per_scene, spec["limits"])
    correct = correct and failed == 0

    unit = {m["name"]: m["unit"] for m in cell["end_to_end"]
            + cell["per_layer"]}
    metrics = {}
    if not trace:
        names = {m["name"] for m in cell["end_to_end"]}
        if times:
            metrics["images_per_s"] = views_done / (last_end - t_start)
        if "scene_p90_ms" in names:
            # the 90th percentile needs 10 scenes beyond it
            if len(times) >= P90_MIN_SCENES:
                metrics["scene_p90_ms"] = 1e3 * p90(times)
            else:
                print(f"scene_p90_ms left out: {len(times)} scenes in the "
                      f"window, fewer than {P90_MIN_SCENES}",
                      file=sys.stderr, flush=True)
        metrics["setup_s"] = setup_s
    else:
        peaks = registry.load_json(os.path.join(registry.HERE, "peaks.json"))
        name = torch.cuda.get_device_name(dev) if on_card else "cpu"
        ctx = dict(scenes=scenes, trace=tr, counts=counts,
                   peaks=peaks.get(name))
        for m in cell["per_layer"]:
            value = registry.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = value
    result = dict(
        correct=bool(correct), attempted=attempted, failed=failed,
        metrics={k: dict(value=v, unit=unit[k]) for k, v in metrics.items()},
        device=dict(platform="gpu" if on_card else "cpu",
                    kind=(torch.cuda.get_device_name(dev) if on_card
                          else "cpu"),
                    count=int(cell["entry"]["chips"]),
                    memory_peak_bytes=int(peak)))
    if trace:
        lo, hi = tr.window()
        result["device"].update(busy_s=1e-6 * tr.busy_us(),
                                window_s=1e-6 * (hi - lo))
        result["breakdown"] = dict(device_ops=tr.device_ops(),
                                   idle_gaps=tr.idle_gaps())
    result["checks"] = checks
    result["_info"] = dict(
        scenes_in_window=len(times), scene_ms=[1e3 * t for t in times],
        sample=sorted(prog_out), numbers=per_scene,
        kernel_counts=[{k: registry.kernel_count(k).count(c)
                        for k in ("K1", "K2", "K3")} for c in counts])
    return result


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    root = os.path.dirname(registry.HERE)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, sub)
    cell = registry.cell(args.workload)
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}",
              file=sys.stderr)
        return 3
    info = result.pop("_info")
    print(f"card: {card_line()}", flush=True)
    print(f"scenes in the window: {info['scenes_in_window']}; attempted "
          f"{result['attempted']}, failed {result['failed']}; scene ms "
          f"{json.dumps([round(t, 3) for t in info['scene_ms']])}",
          flush=True)
    print(f"peak device memory {result['device']['memory_peak_bytes']} B; "
          f"sampled scenes {info['sample']}; "
          f"numbers per scene {json.dumps(info['numbers'])}", flush=True)
    print(f"kernel counts (operations, bytes) of the sampled scenes "
          f"{json.dumps(info['kernel_counts'])}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
