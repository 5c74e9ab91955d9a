"""Build, load, check and count the hand-written CUDA kernels.

The kernels live in ``line3dpp_tpu_torch/csrc/*.cu``, each behind a plain C
interface.  At first use every source is compiled by ``nvcc`` for ``sm_90a``
(one compiler process per source, all started together), the objects are
linked into one shared library under ``build/kernels/<source hash>/`` of the
checkout, and the library is loaded with ``ctypes``.  Nothing is built or
loaded when a module is imported, so the CPU-only tests import everything.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.
``LAUNCHES`` counts the calls that launched a kernel, per wrapper, for the
whole process; each wrapper counts its launch through
``line3dpp_tpu_torch.obs.launched``, which while spans record also adds
the launch to the innermost open span (``obs.summary``).  The wrappers
are in ``ops/matching.py`` (K1: ``match_pairs``), ``ops/scoring.py`` (K2:
``score_matches``), ``ops/affinity.py`` (K3), ``ops/lsd_cc.py`` (K4),
``ops/lsd_gather.py`` (K5, K6: ``gather_labels`` and ``gather_merged``)
and ``ops/lsd_fit.py`` (K7-K11; K9: ``gate_pixels`` and
``consume_survivors``; K10: ``band_counts`` and ``rescue_counts``).  Two
kernels replace no Pallas kernel: line bundling's Levenberg-Marquardt
loop, ``csrc/bundling.cu`` behind ``ops/bundling.lm_optimize_cuda``
(``lm_bundle``), and the collinearity edges, ``csrc/collinearity.cu``
behind ``ops/collinearity.collinear_edges_cuda`` (``collinear_edges``: a
count and a write launch, counted once a call); the JAX package computes
both with XLA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libl3dkernels.so"

LAUNCHES = {"match_pairs": 0, "score_matches": 0,
            "gather_target_estimates": 0, "cc_tiles": 0,
            "apply_merge_dense": 0, "gather_labels": 0, "gather_merged": 0,
            "moments": 0, "gate_moments": 0, "gate_pixels": 0,
            "consume_survivors": 0, "band_counts": 0, "rescue_counts": 0,
            "extents": 0, "lm_bundle": 0, "collinear_edges": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    # 13 inputs (the first the (V, S, 4) target table), P S knn,
    # epipolar_overlap, list_len, the overflow path's key scratch, flagged
    # rows and their count, 6 outputs and the validity, stream
    "l3d_match_pairs": ([_P] * 13 + [_I] * 3 + [_F] + [_I] + [_P] * 3
                        + [_P] * 7 + [_P]),
    # 10 inputs, V S M N knn, two_sig_a_sqr min_similarity, orientation,
    # the pre-test's cos_lo lp, records a segment, the overflow path's
    # record scratch, flagged segments and their count, 2 outputs, stream
    "l3d_score_matches": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_I] + [_F] * 2
                          + [_I] + [_P] * 5 + [_P] * 2 + [_P]),
    # 4 inputs, V_tab S V M N knn, 2 outputs, stream
    "l3d_gather_target_estimates": [_P] * 4 + [_I] * 6 + [_P] * 2 + [_P],
    # angle active, hp wp th tw ph pw, tol, labels unconverged, stream
    "l3d_cc_tiles": [_P] * 2 + [_I] * 6 + [_F] + [_P] * 2 + [_P],
    # lab T, total, out, stream
    "l3d_apply_merge_dense": [_P] * 2 + [_L] + [_P] + [_P],
    # src idx, n, out, stream
    "l3d_gather_labels": [_P] * 2 + [_L] + [_P] + [_P],
    # lab T idx, total n, out, stream
    "l3d_gather_merged": [_P] * 3 + [_L] * 2 + [_P] + [_P],
    # slot xs ys mag pix starts, n C threads, out, stream
    "l3d_moments": [_P] * 6 + [_I] * 3 + [_P] + [_P],
    # slot xs ys ang mag pix tables starts, n C threads dump_keep, cos_tol,
    # newpix out, stream
    "l3d_gate_moments": [_P] * 8 + [_I] * 4 + [_F] + [_P] * 2 + [_P],
    # slot xs ys ang pix tables, n C dump_keep, cos_tol, newpix, stream
    "l3d_gate_pixels": [_P] * 6 + [_I] * 3 + [_F] + [_P] + [_P],
    # slot xs ys ang idx mag tables, n C items, cos_tol, status status_len
    # epoch, idx mag ang count outputs, stream
    "l3d_consume_survivors": ([_P] * 7 + [_I] * 3 + [_F] + [_P, _L, _U]
                              + [_P] * 4 + [_P]),
    # slot xs ys ang pix tables bands starts, n C B half span, cos_tol,
    # words words_len epoch, out, stream
    "l3d_band_counts": ([_P] * 8 + [_I] * 5 + [_F] + [_P, _L, _U] + [_P]
                        + [_P]),
    # slot xs ys pix tables starts, n C, out, stream
    "l3d_extents": [_P] * 6 + [_I] * 2 + [_P] + [_P],
    # params0 order offsets, 6 observation arrays, C iterations, params
    # accepted, stream
    "l3d_lm_optimize": [_P] * 9 + [_I] * 2 + [_P] * 2 + [_P],
    # segments mask P1 P2 d1 d2 valid k_reg cut, V S T, t_px min_affinity,
    # counts written, stream
    "l3d_collinear_count": [_P] * 9 + [_I] * 3 + [_F] * 2 + [_P] + [_P],
    # the same, counts ends edges, stream
    "l3d_collinear_write": [_P] * 9 + [_I] * 3 + [_F] * 2 + [_P] * 3 + [_P],
}
# entry points that return a size, not an error: arguments, result
_QUERIES = {"l3d_match_all_scratch": ([_I], _L),
            "l3d_score_overflow_blocks": ([], _L)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are compiled "
            "from line3dpp_tpu_torch/csrc at first use")
    return path


def library_path() -> str:
    """Path of the kernel library for the current sources, built if absent.

    The build writes ``build.log`` beside the library with each source's
    ``ptxas -v`` report (registers, shared memory, spills)."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib

    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
        failed = [src for src, _, proc in jobs if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *[o for _, o, _ in jobs],
             "-o", os.path.join(tmp, LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        with open(os.path.join(tmp, "build.log"), "w") as f:
            f.write("\n".join(log))
        try:
            os.rename(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not os.path.exists(lib):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in _QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.l3d_error_string.argtypes = [ctypes.c_int]
    lib.l3d_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if the launch reported an error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.l3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def query(name: str, *args) -> int:
    """The size that C entry point ``name`` of ``_QUERIES`` returns."""
    return int(getattr(library(), name)(*args))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel argument must be."""
    if device.type != "cuda":
        raise ValueError(f"{name}: kernel arguments must be CUDA tensors")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
