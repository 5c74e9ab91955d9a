"""Unified CLI: the reference's six ``runLine3Dpp_*`` executables, one
subcommand per SfM format, on a CUDA device.

    python -m line3dpp_tpu_torch.cli.run vsfm    -i <dir> [-m result.nvm] ...
    python -m line3dpp_tpu_torch.cli.run colmap  -i <imgdir> -m <sparse_dir> ...
    python -m line3dpp_tpu_torch.cli.run bundler -i <dir> [-m bundle.rd.out] ...
    python -m line3dpp_tpu_torch.cli.run mavmap  -i <dir> -m <data.txt> -f FX,FY,CX,CY
    python -m line3dpp_tpu_torch.cli.run pix4d   -i <dir> -m <params_dir> ...
    python -m line3dpp_tpu_torch.cli.run openmvg -i <dir> -m <sfm_data.json> ...

The parser, flags and output names are those of ``line3dpp_tpu.cli.run``
(the reference CLI, main_vsfm.cpp:44-93): -w max image width, -n
neighbors, -a sigma_a, -p sigma_p, -e epipolar overlap, -k kNN, -y max
segments, -v visibility, -d diffusion, -l load/store segments, -r
collinearity, -c bundling, -z const reg depth.  It runs on the CUDA device
and raises without one unless ``--cpu`` is given.  All images go through
one ``Line3D.add_images`` call, which batches the detection; binary 8-bit
PGM/PPM images are read without Pillow (``utils/images.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="line3dpp_tpu_torch")
    ap.add_argument("format", choices=["vsfm", "colmap", "bundler", "mavmap",
                                       "pix4d", "openmvg"])
    ap.add_argument("-i", "--image_folder", required=True)
    ap.add_argument("-m", "--model", default=None,
                    help="SfM result (nvm file / sparse dir / bundle file / "
                         "image-data txt / params dir / sfm_data.json)")
    ap.add_argument("-o", "--output_folder", default=None)
    ap.add_argument("-w", "--max_image_width", type=int, default=-1)
    ap.add_argument("-n", "--num_neighbors", type=int, default=10)
    ap.add_argument("-a", "--sigma_a", type=float, default=10.0)
    ap.add_argument("-p", "--sigma_p", type=float, default=2.5)
    ap.add_argument("-e", "--epipolar_overlap", type=float, default=0.25)
    ap.add_argument("-k", "--knn", type=int, default=10)
    ap.add_argument("-y", "--max_segments", type=int, default=3000)
    ap.add_argument("-v", "--visibility", type=int, default=3)
    ap.add_argument("-d", "--diffusion", action="store_true")
    # reference -l/--load_and_store_flag takes a bool value, default ON
    # (main_vsfm.cpp loadArg)
    ap.add_argument("-l", "--load_segments", type=int, default=1,
                    help="load/store detected segments on disk (1=on, 0=off)")
    ap.add_argument("-r", "--collinearity", type=float, default=-1.0)
    ap.add_argument("-c", "--optimize", action="store_true", default=True)
    ap.add_argument("--no-optimize", dest="optimize", action="store_false")
    ap.add_argument("-z", "--const_reg_depth", type=float, default=-1.0)
    ap.add_argument("-f", "--pinhole", default=None,
                    help="mavmap: FX,FY,CX,CY")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--min_image_width", type=int, default=800,
                    help="reject images narrower than this (line3D.cc:119)")
    return ap


def load_views(args):
    """The posed views of ``args.model`` and whether the format carries
    worldpoints."""
    from .. import io as sfm_io

    img = args.image_folder
    m = args.model
    if args.format == "vsfm":
        m = m or os.path.join(img, "result.nvm")
        return sfm_io.read_nvm(m, img), True
    if args.format == "colmap":
        if not m:
            sys.exit("colmap requires -m <sparse_model_dir>")
        return sfm_io.read_colmap(m, img), True
    if args.format == "bundler":
        m = m or os.path.join(img, "bundle.rd.out")
        return sfm_io.read_bundler(m, img), True
    if args.format == "mavmap":
        # rows normally carry fx/fy/cx/cy; -f is an optional override for
        # truncated files
        K = None
        if args.pinhole:
            fx, fy, cx, cy = map(float, args.pinhole.split(","))
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        return sfm_io.read_mavmap(m or img, img, K), False
    if args.format == "pix4d":
        if not m:
            sys.exit("pix4d requires -m <params_dir>")
        return sfm_io.read_pix4d(m, img), False
    if args.format == "openmvg":
        if not m:
            sys.exit("openmvg requires -m <sfm_data.json>")
        return sfm_io.read_openmvg(m, img), True
    raise AssertionError


@dataclasses.dataclass
class CliRun:
    """What :func:`main` did: the pipeline, the output files' common path
    (``<out_dir>/<tag>``, add ``.txt``/``.stl``/``.obj``/``.bin``) and the
    wall time of each phase in seconds."""

    pipe: object
    base: str
    phases: dict


def main(argv=None) -> CliRun:
    import line3dpp_tpu_torch as l3d
    from ..io.mavmap import sequential_neighbors
    from ..utils.images import read_gray

    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else None
    phases = {}
    t0 = time.perf_counter()
    views, has_worldpoints = load_views(args)
    print(f"[L3D-TPU] loaded {len(views)} posed views ({args.format})")

    cfg = l3d.Config(
        max_image_width=args.max_image_width,
        num_neighbors=args.num_neighbors,
        sigma_a=args.sigma_a, sigma_p=args.sigma_p,
        epipolar_overlap=args.epipolar_overlap, knn=args.knn,
        max_line_segments=args.max_segments, visibility_t=args.visibility,
        perform_rdd=args.diffusion, load_segments=bool(args.load_segments),
        collinearity_t=args.collinearity, optimize=args.optimize,
        const_regularization_depth=args.const_reg_depth,
        min_image_width=args.min_image_width,
    )
    # raises without a CUDA device unless --cpu
    pipe = l3d.Line3D(cfg, device=device)

    out_dir = args.output_folder or os.path.join(args.image_folder,
                                                 "Line3D-TPU")
    cache = (os.path.join(out_dir, "L3D_cache")
             if args.load_segments else None)
    os.makedirs(out_dir, exist_ok=True)
    phases["load_views_s"] = time.perf_counter() - t0

    print("[L3D-TPU] [1] ADDING IMAGES")
    t0 = time.perf_counter()
    items = []
    for v in views:
        if not v.image_path or not os.path.exists(v.image_path):
            print(f"[L3D-TPU] warning: missing image {v.image_path}; skipped")
            continue
        img = read_gray(v.image_path)
        H, W = img.shape
        K = v.K.copy()
        if K[0, 2] < 0:       # principal point = image center (NVM/bundler)
            K[0, 2] = W / 2.0
            K[1, 2] = H / 2.0
        if v.distortion is not None and np.any(np.abs(v.distortion) > 1e-12):
            img = l3d.undistort_image(img, K, v.distortion,
                                      device=pipe.device)
        cam = l3d.Camera(K, v.R, v.t, W, H, median_depth=v.median_depth)
        items.append((v.cam_id, cam, img,
                      v.worldpoints if has_worldpoints else None))
    phases["read_images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.add_images(items, cache_dir=cache)
    for it in items:
        if it[0] in pipe._views:
            print(f"[L3D-TPU]   view {it[0]}: "
                  f"{len(pipe._views[it[0]].segments)} segments")
    _sync(pipe.device)
    phases["add_images_s"] = time.perf_counter() - t0

    if args.format == "mavmap":
        for cam_id, nbrs in sequential_neighbors(
                len(views), args.num_neighbors).items():
            pipe.set_visual_neighbors(cam_id, nbrs)

    print("[L3D-TPU] [2] LINE MATCHING")
    t0 = time.perf_counter()
    pipe.match_images()
    _sync(pipe.device)
    phases["match_images_s"] = time.perf_counter() - t0
    print("[L3D-TPU] [3] RECONSTRUCTION")
    t0 = time.perf_counter()
    lines = pipe.reconstruct_3d_lines()
    phases["reconstruct_3d_lines_s"] = time.perf_counter() - t0
    print(f"[L3D-TPU] reconstructed {len(lines)} 3D lines")

    t0 = time.perf_counter()
    tag = cfg.filename_tag(args.max_image_width if args.max_image_width > 0
                           else -1)
    base = os.path.join(out_dir, tag)
    pipe.save_txt(base + ".txt")
    pipe.save_stl(base + ".stl")
    pipe.save_obj(base + ".obj")
    pipe.save_bin(base + ".bin")
    phases["save_s"] = time.perf_counter() - t0
    print(f"[L3D-TPU] results written to {out_dir}")
    print("[L3D-TPU] phases (s): " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in phases.items()))
    return CliRun(pipe, base, phases)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
