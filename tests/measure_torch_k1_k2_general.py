#!/usr/bin/env python3
"""The general forms of kernels K1 (k > 16) and K2 (M > 1024) against an
earlier version of their sources, on one GPU, in turns (old, new, new,
old), on the inputs ``chip_smoke.py`` gives them, and by parts.

    python tests/measure_torch_k1_k2_general.py --old DIR [--out DIR]
        [--rounds 2] [--profile] [--parts] [--power] [--lists 32,64]
        [--records 256,512,768]

``--old`` is a checkout of the tree whose ``line3dpp_tpu_torch/csrc/
matching.cu`` and ``scoring.cu`` hold the earlier general forms (a warp per
row and a lane per target for K1; a counting pass, an exclusive sum, one
host read and records in a global scratch for K2), for example ``mkdir -p
build/old && git archive <commit> | tar -x -C build/old``; they are
compiled with the package's nvcc flags into a library of their own and
called through their C interfaces, on preallocated outputs.  Every output
of the two versions must be equal bit for bit.

Inputs: K1 at k = 20 on the 26 bundled views (416 pairs) and at k = S =
3000 on the 48 pairs of views 0-2 (one all-matches block), each version
giving the six tables and the validity (the old kernel, then the ``overlap
> 0`` pass its wrapper ran; the new kernel writes it); K2 on that
block's table (M = 48,000), and K2's first form (the old tree's, M <= 1024)
against the new general form on the main path's M = 160 tables.  Times:
``device_ms`` (calls queued behind a sleep kernel: the card's time per
call) where a call does not sync with the host, ``device_sum_ms`` (the
card's kernels, copies and memsets summed by torch.profiler) for K2, and
``event_ms`` (CUDA events around the calls, the host's share included).

``--parts`` builds copies of both trees' sources with parts switched off
(``PARTS``: each a text substitution, whose outputs are no longer the
function's) and times each on the same inputs.  ``--lists`` and
``--records`` time the new forms at other list lengths (K1 at k = S) and
record counts (K2 on the block), and print how many rows or segments
overflow at each.  ``--power`` samples the card's clocks and power draw
(nvidia-smi, every 50 ms) while each K1 version runs back to back at k =
S.  ``--profile`` prints each version's device time by kernel.  Prints one JSON line at the end and writes it to
``--out``/k1_k2_general.json.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# (tree, source) -> {part: [(old text, new text, occurrence)]}; occurrence
# -1 is the last.  "old" is the earlier tree (the warp-per-row K1, the
# counting K2), "new" this one.
PARTS = {
    ("old", "matching.cu"): {
        # the targets from one line of L1 (the pass pattern changes)
        "l1_targets": [("const float4 q = __ldg(tq + g);",
                        "const float4 q = __ldg(tq + tgt_row + lane);", -1)],
        "no_writes": [("    for (int j = lane; j < k; j += 32) {\n"
                       "      int32_t idx = 0;",
                       "    for (int j = lane; j < k && k < 0; j += 32) {\n"
                       "      int32_t idx = 0;", -1)],
        "no_sort_writes": [
            ("    for (int j = lane; j < k; j += 32) {\n"
             "      int32_t idx = 0;",
             "    for (int j = lane; j < k && k < 0; j += 32) {\n"
             "      int32_t idx = 0;", -1),
            ("    if (n <= 32) {", "    if (k < 0) {", -1),
            ("    } else {\n      int n2 = 64;",
             "    } else if (k < -1) {\n      int n2 = 64;", -1)],
        "pretest_only": [
            ("    for (int j = lane; j < k; j += 32) {\n"
             "      int32_t idx = 0;",
             "    for (int j = lane; j < k && k < 0; j += 32) {\n"
             "      int32_t idx = 0;", -1),
            ("    if (n <= 32) {", "    if (k < 0) {", -1),
            ("    } else {\n      int n2 = 64;",
             "    } else if (k < -1) {\n      int n2 = 64;", -1),
            ("          pass = pretest_target(r.e, q, cut) &&\n",
             "          pass = pretest_target(r.e, q, cut);\n"
             "          if (k < 0) pass = pass &&\n", -1)],
    },
    ("old", "scoring.cu"): {
        "no_pairs": [("  if (nv == 0) return;\n  __syncwarp();  // the "
                      "records are read back by other lanes",
                      "  return;", -1)],
        "no_zeros": [("      SL[r] = m;\n    } else if (m < M) {",
                      "      SL[r] = m;\n    } else if (m < M && knn < 0) {",
                      -1)],
        "no_staging": [("      if (lane < n) {\n        TA[lane]",
                        "      if (lane < n && knn < 0) {\n        TA[lane]",
                        -1),
                       ("pair_step<0>(TA, TB, n,",
                        "pair_step<0>(A + cb, B + cb, n,", -1)],
        "walk_only": [
            ("  if (nv == 0) return;\n  __syncwarp();  // the records are "
             "read back by other lanes", "  return;", -1),
            ("      SL[r] = m;\n    } else if (m < M) {",
             "      SL[r] = m;\n    } else if (m < M && knn < 0) {", -1),
            ("      ok = slot_setup(o, m, v, vs, N, knn, d_p1, d_p2, ray1, "
             "ray2, raym, C,\n                      k_reg, tgt_C, tgt_k, "
             "check_orientation, ea, eb);\n      eb.y = __int_as_float(m / "
             "knn);",
             "      ok = knn < 0;\n      ea = eb = make_float4(0.f, 0.f, "
             "0.f, 0.f);", -1)],
    },
    ("new", "matching.cu"): {
        # layouts, not parts: the block form's registers bounded for 4 or 5
        # blocks an SM
        "minb4": [("__launch_bounds__(TILE + 32) match_list_kernel(",
                   "__launch_bounds__(TILE + 32, 4) match_list_kernel(", -1)],
        "minb5": [("__launch_bounds__(TILE + 32) match_list_kernel(",
                   "__launch_bounds__(TILE + 32, 5) match_list_kernel(", -1)],
        # a layout, not a part: no writer warp; the scanning threads write
        # a part of the zeros with each chunk of targets
        "interleaved": [
            ("// Barriers of the block form:",
             "__device__ __forceinline__ void zero_block(float* q, int64_t n)"
             " {\n  int64_t h = (int64_t)(((16 - ((uintptr_t)q & 15)) & 15) "
             ">> 2);\n  h = h < n ? h : n;\n  if (threadIdx.x < h) "
             "q[threadIdx.x] = 0.0f;\n  const int64_t body = (n - h) >> 2;\n"
             "  float4* q4 = reinterpret_cast<float4*>(q + h);\n  for "
             "(int64_t i = threadIdx.x; i < body; i += TILE) q4[i] = "
             "make_float4(0.f, 0.f, 0.f, 0.f);\n  const int64_t done = h + "
             "(body << 2);\n  if (threadIdx.x < n - done) q[done + "
             "threadIdx.x] = 0.0f;\n}\n\n// Barriers of the block form:", -1),
            ('"n"(TILE + 32)', '"n"(TILE)', -1),
            ("match_list_kernel<<<grid, TILE + 32, smem, st>>>(",
             "match_list_kernel<<<grid, TILE, smem, st>>>(", -1),
            ("  if (pair_ok) {\n    const int nchunk = (S + CHUNK - 1) / CHUNK;",
             "  const int nchunk = (S + CHUNK - 1) / CHUNK;\n"
             "  const int64_t zo = (ps + (int64_t)blockIdx.y * TILE) * k;\n"
             "  const int64_t zn = (int64_t)min(TILE, S - (int)blockIdx.y * "
             "TILE) * k;\n"
             "  float* zouts[6] = {reinterpret_cast<float*>(out_idx), out_ov,"
             " out_dp1, out_dp2, out_dq1, out_dq2};\n"
             "  auto zero_part = [&](int part) {\n"
             "    const int64_t lo = zn * part / nchunk, hi = zn * (part + 1) "
             "/ nchunk;\n"
             "    for (int a = 0; a < 6; ++a) zero_block(zouts[a] + zo + lo, "
             "hi - lo);\n  };\n"
             "  if (!pair_ok) for (int q = 0; q < nchunk; ++q) zero_part(q);\n"
             "  if (pair_ok) {", -1),
            ("      scan_sync();\n      if (live) {\n        const float4* "
             "cur = buf + (chunk & 1) * CHUNK;",
             "      scan_sync();\n      zero_part(chunk);\n      if (live) "
             "{\n        const float4* cur = buf + (chunk & 1) * CHUNK;", -1)],
        # the writer warp alone: no scan
        "zeros_only": [("  const bool pair_ok = pair_valid[p] != 0;  // uniform",
                        "  const bool pair_ok = pair_valid[p] != 0 && k < 0;"
                        "  // uniform", -1)],
        "no_zeros": [("    zero_span(reinterpret_cast<float*>(out_idx) + o, "
                      "n, lane);", "    if (k < 0) {", -1),
                     ("    zero_bytes(out_ok + o, n, lane);",
                      "    zero_bytes(out_ok + o, n, lane); }", -1)],
        "no_writes": [("    zero_span(reinterpret_cast<float*>(out_idx) + o, "
                       "n, lane);", "    if (k < 0) {", -1),
                      ("    zero_bytes(out_ok + o, n, lane);",
                       "    zero_bytes(out_ok + o, n, lane); }", -1),
                      ("    for (int j = lane; j < c; j += 32) {",
                       "    for (int j = lane; j < c && k < 0; j += 32) {",
                       -1)],
        "pretest_only": [
            ("    zero_span(reinterpret_cast<float*>(out_idx) + o, n, lane);",
             "    if (k < 0) {", -1),
            ("    zero_bytes(out_ok + o, n, lane);",
             "    zero_bytes(out_ok + o, n, lane); }", -1),
            ("    for (int j = lane; j < c; j += 32) {",
             "    for (int j = lane; j < c && k < 0; j += 32) {", -1),
            ("            if (!exact_overlap_len(r.e, cur[c + u], cl[c + u], "
             "overlap))",
             "            if (k > -5 || !exact_overlap_len(r.e, cur[c + u], "
             "cl[c + u], overlap))", -1)],
    },
    ("new", "scoring.cu"): {
        "no_pairs": [("q0 < ng; q0 += SEG_THREADS) {",
                      "q0 < ng && knn < 0; q0 += SEG_THREADS) {", -1)],
        "no_zeros": [("  if (zeros) {", "  if (zeros && knn < 0) {", -1)],
        "walk_zeros": [("      ok = slot_setup(o0 + m, m, v, vs, N, knn, "
                        "d_p1, d_p2, ray1, ray2, raym,\n                   "
                        "   C, k_reg, tgt_C, tgt_k, check_orientation, ea, "
                        "eb);", "      ok = knn < 0;\n      ea = eb = "
                        "make_float4(0.f, 0.f, 0.f, 0.f);", -1)],
        "walk_only": [("      ok = slot_setup(o0 + m, m, v, vs, N, knn, "
                       "d_p1, d_p2, ray1, ray2, raym,\n                   "
                       "   C, k_reg, tgt_C, tgt_k, check_orientation, ea, "
                       "eb);", "      ok = knn < 0;\n      ea = eb = "
                       "make_float4(0.f, 0.f, 0.f, 0.f);", -1),
                      ("  if (zeros) {", "  if (zeros && knn < 0) {", -1)],
        "zeros_only": [("  const int nv = list_valid(valid + o0, M, SL, cap, "
                        "wsum, parity);", "  const int nv = 0;", -1)],
    },
}


def substitute(text: str, old: str, new: str, occurrence: int) -> str:
    """``text`` with the ``occurrence``-th ``old`` (-1: the last) replaced."""
    starts = [m.start() for m in re.finditer(re.escape(old), text)]
    if not starts:
        raise ValueError(f"not in the source: {old!r}")
    at = starts[occurrence]
    return text[:at] + new + text[at + len(old):]


def build(specs: dict) -> dict:
    """Each ``specs`` entry (name -> {file name: text}) compiled with the
    package's flags into build/kernels_general/<hash>/lib<name>.so, once;
    one nvcc for each library, all started together."""
    from line3dpp_tpu_torch.ops import kernels

    libs, jobs = {}, []
    for name, sources in specs.items():
        h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
        for f in sorted(sources):
            h.update(f.encode() + sources[f].encode())
        out = os.path.join(REPO, "build", "kernels_general",
                           h.hexdigest()[:16])
        libs[name] = os.path.join(out, f"lib{name}.so")
        if os.path.exists(libs[name]):
            continue
        os.makedirs(out, exist_ok=True)
        paths = []
        for f, text in sources.items():
            paths.append(os.path.join(out, f))
            with open(paths[-1], "w") as fh:
                fh.write(text)
        jobs.append((name, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", *paths, "-o", libs[name]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            chip_smoke.fail(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Function properties for (\S+)|Used (\d+) "
                          r"registers", log)
        print(f"built {name}: " + " ".join(a or b for a, b in regs),
              flush=True)
    return {name: ctypes.CDLL(path) for name, path in libs.items()}


def read(root: str, f: str) -> str:
    with open(os.path.join(root, "line3dpp_tpu_torch", "csrc", f)) as fh:
        return fh.read()


def bind(lib: ctypes.CDLL, tree: str) -> ctypes.CDLL:
    """Argument types of the entry points each tree's sources define."""
    sig = {"l3d_match_all_scratch": ([_I], _L)}
    if tree == "old":
        sig.update({
            "l3d_match_pairs_all": ([_P] * 13 + [_I] * 3 + [_F] + [_P] * 7
                                    + [_P], _I),
            "l3d_score_count_valid": ([_P, _L, _I, _P, _P], _I),
            "l3d_score_matches": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_I]
                                  + [_F] * 2 + [_P] * 3, _I),
            "l3d_score_matches_all": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_I]
                                      + [_F] * 2 + [_P] * 7, _I)})
    else:
        sig.update({
            "l3d_match_pairs_all": ([_P] * 13 + [_I] * 3 + [_F] + [_I]
                                    + [_P] * 10 + [_P], _I),
            "l3d_score_overflow_blocks": ([], _L),
            "l3d_score_matches_all": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_I]
                                      + [_F] * 2 + [_I] + [_P] * 7 + [_P],
                                      _I)})
    for name, (args, res) in sig.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return lib


class Calls:
    """Each tree's general forms on preallocated outputs and scratch."""

    def __init__(self, dev):
        import torch
        from line3dpp_tpu_torch.ops import kernels

        self.torch, self.dev = torch, dev
        self.p, self.stream = kernels.ptr, kernels.stream(dev)

    def ok(self, rc, what):
        if rc != 0:
            chip_smoke.fail(f"{what}: CUDA error {rc}")

    def k1_outputs(self, t, k):
        torch = self.torch
        P, S = t.num_src.shape
        return [torch.zeros((P, S, k), dtype=torch.int32,
                            device=self.dev)] + [
            torch.zeros((P, S, k), device=self.dev) for _ in range(5)] + [
            torch.zeros((P, S, k), dtype=torch.bool, device=self.dev)]

    def k1(self, lib, tree, t, eo, k, outs, list_len=None):
        """The general form of K1 at k into ``outs`` (the six tables and
        the validity: the old tree's kernel, then the ``overlap > 0`` its
        wrapper took; the new one writes it)."""
        torch, p = self.torch, self.p
        P, S = t.num_src.shape
        tabs = [p(x) for x in (t.tq, t.mask, t.r1, t.r2, t.n, t.seglen,
                               t.e1, t.e2, t.num_src, t.num_tgt, t.src_idx,
                               t.tgt_idx, t.pair_valid)]
        o = [p(x) for x in outs]
        scratch = torch.empty(max(lib.l3d_match_all_scratch(S), 1),
                              dtype=torch.int64, device=self.dev)
        if tree == "old":
            def old():
                self.ok(lib.l3d_match_pairs_all(
                    *tabs, P, S, k, eo, p(scratch), *o[:6], self.stream),
                    "old K1")
                torch.gt(outs[1], 0.0, out=outs[6])
            return old
        flagged = torch.empty(P * S, dtype=torch.int32, device=self.dev)
        n_flagged = torch.empty(1, dtype=torch.int32, device=self.dev)
        return lambda: self.ok(lib.l3d_match_pairs_all(
            *tabs, P, S, k, eo, list_len, p(scratch), p(flagged),
            p(n_flagged), *o, self.stream), "new K1")

    def k2_outputs(self, args):
        torch = self.torch
        return (torch.zeros(args[7].shape, device=self.dev),
                torch.zeros(args[7].shape, dtype=torch.bool,
                            device=self.dev))

    def k2(self, lib, tree, args, kw, outs, records=None, form="general"):
        """K2's general form (or the old tree's first form) into ``outs``;
        the old general form with its counting pass, exclusive sum and
        host read of the record count, as its wrapper ran it."""
        torch, p = self.torch, self.p
        from line3dpp_tpu_torch.ops import scoring

        r1, r2, rmid, C, k_reg, tgt_C, tgt_k, d_p1, d_p2, valid = args
        V, S, M = d_p1.shape
        N = tgt_C.shape[1]
        cos_lo, lp = scoring.pretest_thresholds(kw["two_sig_a_sqr"],
                                                kw["min_similarity"])
        inputs = (*(p(a) for a in args[7:10]), *(p(a) for a in args[:7]),
                  V, S, M, N, kw["knn"], float(kw["two_sig_a_sqr"]),
                  float(kw["min_similarity"]),
                  int(kw["check_orientation"]), cos_lo, lp)
        score, ok = (p(x) for x in outs)
        if form == "first":
            return lambda: self.ok(lib.l3d_score_matches(
                *inputs, score, ok, self.stream), "first K2")
        if tree == "new":
            n = lib.l3d_score_overflow_blocks() * M
            rec = [torch.empty((n, 4), device=self.dev) for _ in range(2)]
            slot = torch.empty(n, dtype=torch.int32, device=self.dev)
            flagged = torch.empty(V * S, dtype=torch.int32, device=self.dev)
            n_flagged = torch.empty(1, dtype=torch.int32, device=self.dev)
            return lambda: self.ok(lib.l3d_score_matches_all(
                *inputs, records, p(rec[0]), p(rec[1]), p(slot), p(flagged),
                p(n_flagged), score, ok, self.stream), "new K2")
        counts = torch.empty(V * S, dtype=torch.int32, device=self.dev)

        def old():
            self.ok(lib.l3d_score_count_valid(p(valid), V * S, M, p(counts),
                                              self.stream), "old K2 count")
            ends = torch.cumsum(counts, 0, dtype=torch.int64)
            total = int(ends[-1])
            offsets = (ends - counts).contiguous()
            rec = [torch.empty((max(total, 1), 4), device=self.dev)
                   for _ in range(2)]
            slot = torch.empty(max(total, 1), dtype=torch.int32,
                               device=self.dev)
            self.ok(lib.l3d_score_matches_all(
                *inputs, p(offsets), p(rec[0]), p(rec[1]), p(slot), score,
                ok, self.stream), "old K2")
        return old


def turns(calls: dict, rounds: int, reps: int, syncs: bool) -> dict:
    """Times of each version's call, taken in the order old, new, new, old
    ``rounds`` times; ``syncs``: the calls read from the device, so the
    card's time is the profiler's sum."""
    out = {k: {"device_ms": [], "event_ms": []} for k in calls}
    for k in ["old", "new", "new", "old"] * rounds:
        fn = calls[k]
        out[k]["device_ms"].append(
            chip_smoke.device_sum_ms(fn, reps) if syncs
            else chip_smoke.device_ms(fn, reps))
        out[k]["event_ms"].append(chip_smoke.cuda_ms(fn, reps))
    for k in out:
        for m in ("device_ms", "event_ms"):
            out[k][m + "_mean"] = float(np.mean(out[k][m]))
    return out


def power(fn, secs: float = 2.0) -> dict:
    """The card's SM and memory clocks (MHz) and power draw (W), sampled
    by nvidia-smi every 50 ms while ``fn`` runs back to back for ``secs``
    seconds, and the milliseconds per call over that window."""
    import tempfile
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryFile("w+") as f:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"], stdout=f,
            stderr=subprocess.DEVNULL, text=True)
        try:
            time.sleep(0.3)
            t0, calls = time.perf_counter(), 0
            while time.perf_counter() - t0 < secs:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                calls += 5
            ms = 1e3 * (time.perf_counter() - t0) / calls
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        f.seek(0)
        rows = [[float(x) for x in line.split(",")] for line in f
                if line.strip() and "N/A" not in line]
    rows = np.array(rows[6:-2] if len(rows) > 10 else rows)
    return dict(ms=ms, sm_mhz=float(rows[:, 0].mean()),
                mem_mhz=float(rows[:, 1].mean()),
                power_w=float(rows[:, 2].mean()),
                power_w_max=float(rows[:, 2].max()), samples=len(rows))


def by_kernel(fn, calls: int = 3) -> dict:
    """Device microseconds per call of each kernel, memset and copy that
    ``calls`` runs of ``fn`` launch (torch.profiler)."""
    _, events, _ = chip_smoke.device_events(
        lambda: [fn() for _ in range(calls)])
    out = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
            names = re.findall(r"([A-Za-z_]\w*(?:<[^(]*>)?)\(", e["name"])
            name = names[0] if names else e["name"][:40]
            out[name] = out.get(name, 0.0) + e["dur"] / calls
    return out


def equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="checkout holding the earlier kernel sources")
    ap.add_argument("--out", help="directory for k1_k2_general.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--lists", default="",
                    help="K1 list lengths to time at k = S, comma-separated")
    ap.add_argument("--records", default="",
                    help="K2 record counts to time on the block")
    ap.add_argument("--power", action="store_true",
                    help="sample clocks and power while each version (and "
                         "K1's zeros_only / no_zeros parts) runs at k = S")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    import line3dpp_tpu_torch as lt
    from line3dpp_tpu_torch.ops import matching, scoring
    from line3dpp_tpu_torch.utils.testdata import load_views

    dev = torch.device("cuda")
    srcs = {tree: {f: read(root, f) for f in ("matching.cu", "scoring.cu")}
            for tree, root in (("old", opts.old), ("new", REPO))}
    specs = dict(srcs)
    if opts.parts:
        for (tree, f), parts in PARTS.items():
            for part, subs in parts.items():
                text = srcs[tree][f]
                for old, new, occ in subs:
                    text = substitute(text, old, new, occ)
                specs[f"{tree}_{f[:-3]}_{part}"] = {f: text}
    built = build(specs)
    libs = {tree: bind(built[tree], tree) for tree in srcs}
    variants = {(name.split("_")[0], f"{name.split('_')[1]}.cu",
                 name.split("_", 2)[2]): bind(built[name], name.split("_")[0])
                for name in specs if name not in srcs}
    calls = Calls(dev)
    result = {"card": smi}

    cfg = lt.Config(optimize=False)
    pipe = lt.Line3D(cfg, device="cpu")
    for v in load_views():
        pipe.add_view(v.cam_id, lt.Camera(v.K, v.R, v.t, v.width, v.height),
                      v.segments)
    inp = pipe.step_inputs()
    d = {n: torch.from_numpy(inp[n]).to(dev) for n in (
        "segments", "seg_mask", "RtKinv", "C", "k_reg", "neighbor_ids", "F",
        "pair_valid")}
    V, N = d["neighbor_ids"].shape
    S = d["seg_mask"].shape[1]
    eo = cfg.epipolar_overlap
    src = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(N)
    t = matching.pair_tables(d["segments"], d["seg_mask"], d["RtKinv"],
                             d["C"], src, d["neighbor_ids"].reshape(-1),
                             d["F"].reshape(-1, 3, 3),
                             d["pair_valid"].reshape(-1))
    tb = chip_smoke.pair_subset(t, 0, 3 * N)

    # ---- K1 at k = 20 (416 pairs) and k = S (48 pairs)
    for label, tab, k in (("k1_k20", t, 20), ("k1_kS", tb, S)):
        outs = {tree: calls.k1_outputs(tab, k) for tree in libs}
        fns = {tree: calls.k1(libs[tree], tree, tab, eo, k, outs[tree],
                              matching.LIST_LEN) for tree in libs}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        same = equal(outs["old"], outs["new"])
        rows = (outs["new"][1] > 0).sum(-1)
        print(f"{label}: old and new equal bit for bit: {same}; matches a "
              f"row: mean {float(rows.float().mean()):.3f}, max "
              f"{int(rows.max())}", flush=True)
        chip_smoke.check(same, f"{label}: the new general form differs")
        r = turns(fns, opts.rounds, reps=3, syncs=False)
        r.update(equal=same, rows_over={L: int((rows > L).sum()) for L in
                                        (16, 20, 32, 48, 64, 96, 128)})
        if opts.profile:
            r["by_kernel"] = {tree: by_kernel(fn) for tree, fn in
                              fns.items()}
        if opts.parts:
            r["parts"] = {}
            for (tree, f, part), lib in variants.items():
                if f != "matching.cu":
                    continue
                o = calls.k1_outputs(tab, k)
                r["parts"][f"{tree} {part}"] = chip_smoke.device_ms(
                    calls.k1(lib, tree, tab, eo, k, o, matching.LIST_LEN), 3)
                del o
        if label == "k1_kS" and opts.power:
            r["power"] = {tree: power(fn) for tree, fn in fns.items()}
            for part in ("zeros_only", "no_zeros"):
                lib = variants.get(("new", "matching.cu", part))
                if lib is not None:
                    o = calls.k1_outputs(tab, k)
                    r["power"][f"new {part}"] = power(calls.k1(
                        lib, "new", tab, eo, k, o, matching.LIST_LEN))
                    del o
            print(f"{label} power: {json.dumps(r['power'])}", flush=True)
        if label == "k1_kS":
            r["lists"] = {}
            for L in [int(x) for x in opts.lists.split(",") if x]:
                o = calls.k1_outputs(tab, k)
                fn = calls.k1(libs["new"], "new", tab, eo, k, o, L)
                fn()
                torch.cuda.synchronize()
                chip_smoke.check(equal(o, outs["old"]),
                                 f"K1 at list length {L} differs")
                r["lists"][L] = dict(device_ms=chip_smoke.device_ms(fn, 3),
                                     rows_over=int((rows > L).sum()))
                del o
        result[label] = r
        print(f"{label}: {json.dumps(r)}", flush=True)
        if label == "k1_kS":
            every = matching.PairMatches(*outs["new"])
        del outs, fns
        torch.cuda.empty_cache()

    # ---- K2 on the all-matches block (M = N * S)
    args = chip_smoke.block_k2_args(inp, d, every, 0, 3)
    del every
    kw = dict(knn=S, two_sig_a_sqr=cfg.two_sig_a_sqr,
              min_similarity=cfg.min_similarity_3d,
              check_orientation=cfg.check_match_orientation)
    outs = {tree: calls.k2_outputs(args) for tree in libs}
    fns = {tree: calls.k2(libs[tree], tree, args, kw, outs[tree],
                          scoring.RECORDS) for tree in libs}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    same = equal(outs["old"], outs["new"])
    counts = args[9].sum(-1).reshape(-1)
    print(f"k2_block: old and new equal bit for bit: {same}; valid slots a "
          f"segment: mean {float(counts.float().mean()):.3f}, max "
          f"{int(counts.max())}", flush=True)
    chip_smoke.check(same, "K2: the new general form differs")
    r = turns(fns, opts.rounds, reps=3, syncs=True)
    r["new_device_ms"] = chip_smoke.device_ms(fns["new"], 3)
    r.update(equal=same, segments_over={R: int((counts > R).sum()) for R in
                                        (256, 512, 768, 1024, 2048)})
    if opts.profile:
        r["by_kernel"] = {tree: by_kernel(fn) for tree, fn in fns.items()}
    if opts.parts:
        r["parts"] = {}
        for (tree, f, part), lib in variants.items():
            if f != "scoring.cu":
                continue
            o = calls.k2_outputs(args)
            fn = calls.k2(lib, tree, args, kw, o, scoring.RECORDS)
            r["parts"][f"{tree} {part}"] = chip_smoke.device_sum_ms(fn, 3)
            del o
        # the old counting pass alone
        cnt = torch.empty(counts.numel(), dtype=torch.int32, device=dev)
        r["parts"]["old count pass"] = chip_smoke.device_ms(
            lambda: calls.ok(libs["old"].l3d_score_count_valid(
                calls.p(args[9]), counts.numel(), args[9].shape[2],
                calls.p(cnt), calls.stream), "count"), 3)
    r["records"] = {}
    for R in [int(x) for x in opts.records.split(",") if x]:
        o = calls.k2_outputs(args)
        fn = calls.k2(libs["new"], "new", args, kw, o, R)
        fn()
        torch.cuda.synchronize()
        chip_smoke.check(equal(o, outs["old"]), f"K2 at {R} records differs")
        r["records"][R] = dict(device_ms=chip_smoke.device_ms(fn, 3),
                               segments_over=int((counts > R).sum()))
        del o
    result["k2_block"] = r
    print(f"k2_block: {json.dumps(r)}", flush=True)
    del outs, fns, args
    torch.cuda.empty_cache()

    # ---- K2 at M = 160: the old tree's first form, the new general form
    pm = matching.match_pairs_cuda(t, eo, inp["knn"])
    args = chip_smoke.block_k2_args(inp, d, pm, 0, V)
    kw10 = dict(kw, knn=inp["knn"])
    outs = {tree: calls.k2_outputs(args) for tree in libs}
    fns = {"old": calls.k2(libs["old"], "old", args, kw10, outs["old"],
                           form="first"),
           "new": calls.k2(libs["new"], "new", args, kw10, outs["new"],
                           scoring.RECORDS)}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    same = equal(outs["old"], outs["new"])
    print(f"k2_m160: the first form and the new general form equal bit for "
          f"bit: {same}", flush=True)
    chip_smoke.check(same, "K2 at M = 160: the forms differ")
    r = turns(fns, opts.rounds, reps=10, syncs=False)
    r["device_sum_ms"] = {tree: chip_smoke.device_sum_ms(fn, 10)
                          for tree, fn in fns.items()}
    if opts.profile:
        r["by_kernel"] = {tree: by_kernel(fn) for tree, fn in fns.items()}
    r["equal"] = same
    result["k2_m160"] = r
    print(f"k2_m160 (old: the first form): {json.dumps(r)}", flush=True)

    line = json.dumps(result)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "k1_k2_general.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
