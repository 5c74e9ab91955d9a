"""The port's measuring and validation drivers, counterparts of the
repository's ``tools/`` scripts of the same names: ``bench_scale``
(the blocked pipeline on a large synthetic scene), ``drive_synthetic``
(the pipeline on perfect 2D segments against ground truth),
``validate_scene2`` and ``validate_scene2_anchor`` (configuration sweeps
on the rendered facade).  Each runs as ``python -m
line3dpp_tpu_torch.tools.<name>`` on the CUDA device and raises without
one unless ``--cpu`` is given; importing a driver runs nothing.
"""

from __future__ import annotations

import subprocess

import torch


def device_for(cpu: bool) -> str:
    """``"cpu"`` when asked for, else ``"cuda"``; raises RuntimeError when
    no CUDA device is available, as ``Line3D`` does."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("the drivers run on a CUDA device by default and "
                           "none is available; pass --cpu (device='cpu') "
                           "to run on the CPU")
    return "cuda"


def synchronize(device) -> None:
    """Wait for the card's queued work, so that a host clock read next
    measures it (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return (f"{torch.cuda.get_device_name(0)}, power limit not read "
                f"({type(e).__name__})")
