"""The readings that a cell's limits are set from, in one process.

    python3 -m l3dbench.calibrate --workload <cell>[,<cell>...] \
        --seeds 1,2,... [--control 4] [--scenes 1]

For each cell and seed, the cell's first ``--scenes`` scenes run through
the program as the window runs them, and through the plain reference (its
step on the scene's inputs, its reconstruction from the program's step
outputs); the first ``--control`` seeds also run the control (both stages
of the reference in TF32, ``reference_run``) on the same inputs.  Prints
one JSON line per seed (the numbers of ``compare.numbers`` for the program
against the reference and for the control against the reference, how
many matches both keep differ in score and in affinity by more than each
of ``TOLS``, and the seconds each took), then per cell the lower reading
of each number (the largest over the program's seeds) and its upper
reading (the smallest over the control's).  ``--dump`` keeps each scene's
3D line segments of the three sides in ``DIR/<cell>.<seed>.<scene>.npz``.
Needs a card, as the run does; the benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import compare, drive, program, reference_run, registry

TOLS = (1e-3, 1e-2, 0.1, 0.3)


def off_counts(p: dict, r: dict) -> dict:
    """Of the matches both step tables keep, how many differ in score and
    in affinity weight by more than each tolerance."""
    kp, fp = compare.match_keys(p)
    kr, fr = compare.match_keys(r)
    _, ip, ir = np.intersect1d(kp, kr, assume_unique=True,
                               return_indices=True)
    fp, fr = fp[ip], fr[ir]
    w = lambda s, f: np.where(s["aff_valid"].reshape(-1)[f],  # noqa: E731
                              s["aff_weight"].reshape(-1)[f], 0.0)
    ds = np.abs(p["score"].reshape(-1)[fp].astype(np.float64)
                - r["score"].reshape(-1)[fr])
    dw = np.abs(w(p, fp).astype(np.float64) - w(r, fr))
    return {f"{t:g}": [int((ds > t).sum()), int((dw > t).sum())]
            for t in TOLS}


def calibrate(name, seeds, n_control, n_scenes, dev, dump=None) -> dict:
    cell = registry.cell(name)
    spec, config = cell["spec"], cell["config"]
    options = dict(spec["options"])
    sound, control = [], []
    for k, seed in enumerate(seeds):
        source = registry.generator(config["generator"]).Source(
            config, spec, seed, dev)
        if k == 0:
            drive.scene(program.CLASSES, options, source.scene(-1), dev)
        row = dict(workload=name, seed=seed, program=[], control=[],
                   program_off=[], control_off=[], seconds={})
        for i in range(n_scenes):
            inputs = source.scene(i)
            t0 = time.perf_counter()
            pipe, _ = drive.scene(program.CLASSES, options, inputs, dev)
            prog = drive.outputs(pipe)
            del pipe
            t1 = time.perf_counter()
            ref_step, _ = reference_run.step(options, inputs, dev)
            t2 = time.perf_counter()
            ref_lines = reference_run.recon(options, inputs, prog["state"],
                                            dev)
            t3 = time.perf_counter()
            row["program"].append(compare.numbers(prog, ref_step,
                                                  ref_lines))
            row["program_off"].append(off_counts(prog["step"], ref_step))
            row["seconds"].update(program=t1 - t0, reference_step=t2 - t1,
                                  reference_recon=t3 - t2)
            if k < n_control:
                ctl_step, _ = reference_run.step(options, inputs, dev,
                                                 "tf32")
                ctl_lines = reference_run.recon(options, inputs,
                                                prog["state"], dev, "tf32")
                ctl = dict(step=ctl_step, lines=ctl_lines)
                row["seconds"]["control"] = time.perf_counter() - t3
                row["control"].append(compare.numbers(ctl, ref_step,
                                                      ref_lines))
                row["control_off"].append(off_counts(ctl_step, ref_step))
            row["n_segments"] = [len(prog["lines"]), len(ref_lines)]
            if dump:
                np.savez_compressed(
                    os.path.join(dump, f"{name}.{seed}.{i}.npz"),
                    program=prog["lines"], reference=ref_lines,
                    **(dict(control=ctl_lines) if k < n_control else {}))
        row["correct"] = compare.judge(row["program"], spec["limits"])[0]
        sound += row["program"]
        control += row["control"]
        print(json.dumps(row), flush=True)
    return {n: dict(lower=max(s[n] for s in sound),
                    upper=min((c[n] for c in control), default=None))
            for n in sound[0]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m l3dbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=4)
    p.add_argument("--scenes", type=int, default=1)
    p.add_argument("--dump")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    for name in args.workload.split(","):
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
        readings = calibrate(name, seeds, args.control, args.scenes, dev,
                             args.dump)
        print(json.dumps(dict(workload=name, seeds=len(seeds),
                              control_seeds=min(args.control, len(seeds)),
                              readings=readings)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
