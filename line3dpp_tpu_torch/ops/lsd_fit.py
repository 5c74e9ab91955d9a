"""The LSD rectangle-fit passes over the label-sorted pixel list.

After connected components the active pixels are sorted by component label
(``ops/lsd.py``).  Every pixel carries a component slot in ``[0, C]``: the
slots of real components (runs of >= 5 pixels) increase along the list and
each component is one contiguous run; ``C`` is the dump slot of every other
pixel, and dump pixels lie between the runs.  Per-component tables are
``(C, 8)`` float32 rows ``(cos t, sin t, cx, cy, gate, center, 0, 0)``.

The five passes (JAX package: ``line3dpp_tpu/ops/lsd_fit.py``):

* :func:`moments` (K7): per component Σw, Σwx, Σwy, Σwx², Σwy², Σwxy and
  the pixel count, with w = mag · pix, as a (C, 8) table (column 7 zero);
* :func:`gate_pixels` (K9): keep a pixel when it lies in its component's
  band ``|w_proj - center| <= gate`` and its level-line angle is aligned
  with the component axis (``|cos(ang) ct + sin(ang) st| >= cos_tol``);
  dump pixels are kept when ``dump_keep`` and ``pix != 0``;
* :func:`consume_survivors` (K9's consume form): the (idx, mag, ang) of the
  pixels that the consume gate does not take, in list order: a pixel of a
  real component is consumed when K9's gate keeps it with ``pix = 1``, a
  dump pixel never is.  The kernel gates and compacts in one pass;
* :func:`gate_moments` (K8): K9, then K7 on the gated pixels, in one pass;
* :func:`band_counts` (K10): with the table columns 4 and 5 holding the
  rectangle's ``mid`` and ``width``, per component and band ``(lo_w, lo_c,
  hi_w, hi_c)`` the number of pixels with ``pix != 0`` and ``lo_w width +
  lo_c <= 2 (w_proj - mid) <= hi_w width + hi_c``, as a (C, B) float32
  table, B <= 16;
* :func:`rescue_counts` (K10's rescue form): on the same tables, the count
  of the rescue's p/2 retry (K9's gate with ``center = mid``, half-width
  ``width / 2`` and ``cos_tol``, no dump pixel) in column 0 and the bands'
  counts after it, (C, B + 1), in one pass;
* :func:`extents` (K11): per component, over the pixels with ``pix != 0``,
  min l_proj, min w_proj, min -l_proj, min -w_proj as a (C, 4) table,
  ``BIG`` for a component without such pixels.

Each wrapper launches its CUDA kernel (``csrc/lsd_fit.cu``) for CUDA tensors
and runs its plain torch version for CPU tensors.  The moment sums are
accumulated in float64 by both versions (the product terms are float32, as
in the JAX package), so the two differ only in the last bit of the float32
result; the extents, the gate and the band counts are exact.  K7, K8, K10
and K11 read whole component runs through the run table ``starts``
(:func:`run_starts`); :func:`moments_split` is K7's and K8's split of the
work, in torch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import kernels

BIG = 1e9
TABLE_COLS = 8
# the layouts of kernels K7 and K8: consecutive pixels a thread (fixed by
# the kernel's 16-byte loads), and the threads a block that fit_threads
# chooses and the kernel's launcher takes (csrc/lsd_fit.cu launch_fit)
FIT_ITEMS = 4
FIT_THREADS = 256
FIT_THREADS_LONG = 512
# the consume form of kernel K9 (csrc/lsd_fit.cu gate_kernel<true>): threads
# a block; a block compacts one tile of threads x pixels a thread
# (consume_items)
CONSUME_THREADS = 256
CONSUME_ITEMS_SHORT = 2
CONSUME_ITEMS_LONG = 8
# kernel K10 (csrc/lsd_fit.cu counts_kernel): its columns, the rescue's
# p/2 column included; threads a block; the pixels a warp counts in a short
# and a long list, and blocks an SM of the long layout (count_span)
MAX_BANDS = 16
COUNT_THREADS = 128
COUNT_SPAN_SHORT = 128
COUNT_SPAN_LONG = 256
COUNT_BLOCKS_LONG = 4
# the symmetric width cuts 2 |w_proj - mid| <= width - 0.5 (b + 1)
SYM_BANDS = tuple((-1.0, 0.5 * (b + 1), 1.0, -0.5 * (b + 1))
                  for b in range(4))


def _rows(slot: torch.Tensor, tables: torch.Tensor, C: int):
    """Each pixel's table row (zeros for dump pixels) and the mask of
    pixels in a real component."""
    valid = slot < C
    if C == 0:
        return torch.zeros((slot.numel(), TABLE_COLS), dtype=torch.float32,
                           device=slot.device), valid
    return tables[slot.clamp(max=C - 1).long()], valid


def _moment_terms(xs, ys, mag, pix) -> torch.Tensor:
    """The 7 float32 terms per pixel, in the JAX package's product order."""
    w = mag * pix
    return torch.stack([w, w * xs, w * ys, w * xs * xs, w * ys * ys,
                        w * xs * ys, pix], dim=1)


def moments_plain(slot, xs, ys, mag, pix, C: int) -> torch.Tensor:
    """Per-component sums in float64 over the float32 terms."""
    acc = torch.zeros((C + 1, 7), dtype=torch.float64, device=slot.device)
    acc.index_add_(0, slot.long(), _moment_terms(xs, ys, mag, pix).double())
    out = torch.zeros((C, TABLE_COLS), dtype=torch.float32,
                      device=slot.device)
    out[:, :7] = acc[:C]
    return out


def gate_pixels_plain(slot, xs, ys, ang, pix, tables, dump_keep: bool,
                      cos_tol: float, C: int) -> torch.Tensor:
    row, valid = _rows(slot, tables, C)
    ct, st, cx, cy, gate, center = row[:, :6].unbind(1)
    dxp = xs - cx
    dyp = ys - cy
    w_proj = (-dxp * st + dyp * ct) - center
    aligned = (torch.cos(ang) * ct + torch.sin(ang) * st).abs() >= cos_tol
    keep = (pix != 0.0) & (w_proj.abs() <= gate) & aligned
    dump = (pix != 0.0) if dump_keep else torch.zeros_like(keep)
    return torch.where(valid, keep, dump).to(torch.float32)


def consume_survivors_plain(slot, xs, ys, idx_s, mag_s, ang_s, tables,
                            cos_tol: float, C: int):
    consumed = gate_pixels_plain(slot, xs, ys, ang_s, torch.ones_like(xs),
                                 tables, False, cos_tol, C) != 0.0
    alive = ~consumed
    return idx_s[alive], mag_s[alive], ang_s[alive]


def consume_items(n: int, sms: int) -> int:
    """The pixels a thread of K9's consume form for a list of ``n`` on a
    card of ``sms`` SMs, which its wrapper passes to the kernel: a list that
    fills fewer than one long tile an SM (the facade's, of 45k pixels) is
    cut into short tiles, so it spreads over more blocks; a longer one (real
    photos' round 1, millions) takes long tiles, fewer look-backs.  On an
    H100 80GB HBM3 at 700 W, by ``tests/measure_torch_k6_k9.py
    --consume-layouts`` at ``d36bf17``: 4.8 against 5.7 µs on the facade,
    55.3 against 64.7 µs at 57% active."""
    long_list = sms * CONSUME_THREADS * CONSUME_ITEMS_LONG
    return CONSUME_ITEMS_LONG if n >= long_list else CONSUME_ITEMS_SHORT


def count_span(n: int, sms: int) -> int:
    """The pixels a warp of K10 counts in a list of ``n`` on a card of
    ``sms`` SMs, which its wrapper passes to the kernel: a list that fills
    fewer than one wave of the card in long spans (the facade's rounds,
    tens of thousands of pixels) is cut into short spans, so each warp's
    chain of loads is short; a longer one (real photos' round 1, millions)
    into long spans, which keep more loads in flight.  On an H100 80GB HBM3
    at 700 W, by ``tests/measure_torch_k10.py --layouts`` at ``b2f9d52``,
    16 columns: 7.9 against 10.5 µs on the facade, 66.0 against 74.0 µs at
    57% active."""
    wave = sms * COUNT_BLOCKS_LONG * COUNT_THREADS // 32 * COUNT_SPAN_LONG
    return COUNT_SPAN_SHORT if n < wave else COUNT_SPAN_LONG


def _bands_tensor(bands, device) -> torch.Tensor:
    t = torch.as_tensor(bands, dtype=torch.float32, device=device)
    if t.ndim != 2 or t.shape[1] != 4 or not 1 <= t.shape[0] <= MAX_BANDS:
        raise ValueError(f"bands: shape {tuple(t.shape)}, expected (B, 4) "
                         f"with 1 <= B <= {MAX_BANDS}")
    return t.contiguous()


def band_counts_plain(slot, xs, ys, pix, tables, C: int,
                      bands=SYM_BANDS) -> torch.Tensor:
    bands = _bands_tensor(bands, slot.device)
    row, valid = _rows(slot, tables, C)
    ct, st, cx, cy, mid, width = row[:, :6].unbind(1)
    dxp = xs - cx
    dyp = ys - cy
    w_proj = -dxp * st + dyp * ct
    s = (2.0 * (w_proj - mid))[:, None]
    lo = bands[None, :, 0] * width[:, None] + bands[None, :, 1]
    hi = bands[None, :, 2] * width[:, None] + bands[None, :, 3]
    hit = ((pix != 0.0) & valid)[:, None] & (s >= lo) & (s <= hi)
    acc = torch.zeros((C + 1, bands.shape[0]), dtype=torch.int32,
                      device=slot.device)
    acc.index_add_(0, slot.long(), hit.to(torch.int32))
    return acc[:C].to(torch.float32)


def rescue_counts_plain(slot, xs, ys, ang, pix, tables, C: int, bands,
                        cos_tol: float) -> torch.Tensor:
    mid, width = tables[:, 4], tables[:, 5]
    half = tables.clone()
    half[:, 4] = torch.where(width > 0, 0.5 * width, -1.0)
    half[:, 5] = mid
    keep = gate_pixels_plain(slot, xs, ys, ang, pix, half, False, cos_tol, C)
    acc = torch.zeros((C + 1,), dtype=torch.int32, device=slot.device)
    acc.index_add_(0, slot.long(), (keep != 0.0).to(torch.int32))
    return torch.cat([acc[:C, None].to(torch.float32),
                      band_counts_plain(slot, xs, ys, pix, tables, C, bands)],
                     dim=1)


def run_starts(slot: torch.Tensor, C: int) -> torch.Tensor:
    """The run table of a slot list: int32 (C,), the first position of each
    component's run.  A component with no pixel gets the next component's
    start (``n`` after the last), so the table never decreases and run c
    lies in ``[starts[c], starts[c + 1])`` (``starts[C]`` read as ``n``).
    Built without a host sync."""
    # the latest real component at or before each position never
    # decreases, and first reaches c at component c's head, or at the next
    # component's head when c has no pixel
    latest = torch.where((slot >= 0) & (slot < C), slot, -1).cummax(0).values
    return torch.searchsorted(
        latest, torch.arange(C, dtype=latest.dtype, device=slot.device),
        out_int32=True)


def check_runs(slot: torch.Tensor, C: int) -> None:
    """Raise ``ValueError`` unless each real component's pixels (slot in
    ``[0, C)``) lie in one contiguous run, as kernels K7, K8 and K11 need;
    the detector's pixel list is so by construction.  One host sync."""
    head = (slot >= 0) & (slot < C)
    head[1:] &= slot[1:] != slot[:-1]
    runs = torch.bincount(slot[head].long(), minlength=C)
    if bool((runs > 1).any()):
        c = int(torch.nonzero(runs > 1)[0, 0])
        raise ValueError(f"kernels K7, K8 and K11 need each component's "
                         f"pixels in one run: component {c} has "
                         f"{int(runs[c])} runs")


def fit_threads(n: int, C: int) -> int:
    """The threads a block of kernels K7 and K8 for ``n`` pixels and ``C``
    components, which their wrappers pass to the kernels.  Where components
    average 512 pixels or more (the facade's edges, of thousands), 512
    threads read the runs going on past a block's tiles in half the rounds;
    else (real photos' round 1, tens of pixels) 256 threads, 3 blocks an
    SM.  On an H100 80GB HBM3 at 700 W, in turns by
    ``tests/measure_torch_k7_k8.py --layouts`` at ``f9a3047``: K8 11.7
    against 13.5 µs on the facade, K7 32.9 against 36.1 µs at 57%
    active."""
    return FIT_THREADS_LONG if n >= 512 * C else FIT_THREADS


def moments_split(slot: torch.Tensor, C: int, starts=None,
                  threads=None, blocks=None) -> dict:
    """The split of the work in kernels K7 and K8 (``fit_kernel`` in
    ``csrc/lsd_fit.cu``) over a slot list whose components are runs.

    The list is cut into tiles of ``threads * FIT_ITEMS`` pixels
    (``threads``: :func:`fit_threads` when None), ``FIT_ITEMS`` consecutive
    ones a thread.  Each of ``blocks`` blocks (the kernel's launcher takes
    as many as fit on the card at once; None: one a tile) owns a stretch of
    whole tiles and the runs whose heads lie in it.  A block skips the run
    that began before its stretch, and reads the run going on past the
    stretch's end on to the next component's start, in the tiles after the
    stretch, each pixel in the thread that its place in its tile gives.
    The thread holding a run's last pixel writes the run's row.  K8 gates a
    pixel (and writes its ``newpix``) where it is summed, a dump pixel in
    its own thread.

    Returns, per pixel: ``sums`` (how often it is added to its component's
    sums), ``block`` and ``thread`` (the block and thread that add it, -1
    for none), ``rest`` (added while its block reads past its stretch) and
    ``gates`` (how often K8 gates it); per component: ``writes`` (how often
    its row is written) and ``writer`` (the block whose thread writes it,
    -1 for the blocks past the stretches, which write the zero rows of the
    components with no pixel)."""
    slot = slot.long().cpu()
    n = slot.numel()
    threads = fit_threads(n, C) if threads is None else threads
    span = threads * FIT_ITEMS
    if starts is None:
        starts = run_starts(slot, C)
    nxt = torch.cat([starts.long().cpu(), torch.tensor([n])])
    tiles = -(-n // span)
    blocks = tiles if blocks is None else min(blocks, tiles)
    real = (slot >= 0) & (slot < C)
    pos = torch.arange(n)
    # each block's stretch [c0, c1), the run that began before it and the
    # one going on past it
    b = torch.arange(blocks)
    c0 = b * tiles // blocks * span
    c1 = ((b + 1) * tiles // blocks * span).clamp(max=n)
    block_of = torch.searchsorted(c1, pos, right=True)
    head, last = slot[c0], slot[c1 - 1]
    skip = torch.where((c0 > 0) & real[c0]
                       & (slot[(c0 - 1).clamp(min=0)] == head), head, -1)
    after = torch.where(c1 < n, slot[c1.clamp(max=max(n - 1, 0))], -1)
    cross = torch.where(real[c1 - 1] & (last != skip) & (after == last),
                        last, -1)
    mine = slot != skip[block_of]
    summed = mine & real
    sums, gates = summed.long(), mine.long()
    block = torch.where(summed, block_of, -1)
    thread = torch.where(summed, pos % span // FIT_ITEMS, -1)
    rest = torch.zeros(n, dtype=torch.bool)
    for t in torch.nonzero(cross >= 0)[:, 0].tolist():
        c, lo = int(cross[t]), int(c1[t])
        q = torch.arange(lo, int(nxt[c + 1]))
        q = q[slot[q] == c]
        sums[q] += 1
        gates[q] += 1
        block[q], thread[q] = t, q % span // FIT_ITEMS
        rest[q] = True
    # a run's last pixel: its row is written there, by the block that
    # added it
    last_px = (sums > 0) & real
    last_px[:-1] &= slot[1:] != slot[:-1]
    writes = torch.bincount(slot[last_px], minlength=C)[:C]
    writer = torch.full((C,), -1, dtype=torch.long)
    writer[slot[last_px]] = block[last_px]
    writes += (starts.long().cpu() >= nxt[1:]).long()
    return dict(sums=sums, block=block, thread=thread, rest=rest,
                gates=gates, writes=writes, writer=writer)


def extents_plain(slot, xs, ys, pix, tables, C: int,
                  starts=None) -> torch.Tensor:
    """``starts`` is the kernel's run table and plays no part here."""
    row, valid = _rows(slot, tables, C)
    ct, st, cx, cy = row[:, :4].unbind(1)
    dxp = xs - cx
    dyp = ys - cy
    l_proj = dxp * ct + dyp * st
    w_proj = -dxp * st + dyp * ct
    vals = torch.stack([l_proj, w_proj, -l_proj, -w_proj], dim=1)
    inpix = ((pix != 0.0) & valid)[:, None]
    vals = torch.where(inpix, vals, BIG)
    out = torch.full((C + 1, 4), BIG, dtype=torch.float32, device=slot.device)
    out.scatter_reduce_(0, slot.long()[:, None].expand(-1, 4), vals, "amin")
    return out[:C]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_pixels(C: int, tables=None, **planes) -> tuple[int, torch.device]:
    slot = planes["slot"]
    n, dev = slot.numel(), slot.device
    kernels.check("slot", slot, torch.int32, (n,), dev)
    for name, t in planes.items():
        if name != "slot":
            kernels.check(name, t, torch.float32, (n,), dev)
    if tables is not None:
        kernels.check("tables", tables, torch.float32, (C, TABLE_COLS), dev)
    if n >= 2**31:
        raise ValueError(f"{n} pixels do not fit the kernels' int32 indices")
    return n, dev


def _run_table(slot, C: int, starts, dev) -> torch.Tensor:
    """``starts``, checked, or when it is None the table built from
    ``slot`` after :func:`check_runs` has found each component in one
    run."""
    if starts is None:
        check_runs(slot, C)
        starts = run_starts(slot, C)
    kernels.check("starts", starts, torch.int32, (C,), dev)
    return starts


def moments_cuda(slot, xs, ys, mag, pix, C: int,
                 starts=None) -> torch.Tensor:
    """Kernel K7 over the component runs (``starts`` as for
    :func:`extents_cuda`)."""
    n, dev = _check_pixels(C, slot=slot, xs=xs, ys=ys, mag=mag, pix=pix)
    starts = _run_table(slot, C, starts, dev)
    out = torch.empty((C, TABLE_COLS), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_moments", p(slot), p(xs), p(ys), p(mag), p(pix),
                   p(starts), n, C, fit_threads(n, C), p(out),
                   kernels.stream(dev))
    obs.launched("moments")
    return out


def gate_moments_cuda(slot, xs, ys, ang, mag, pix, tables, dump_keep: bool,
                      cos_tol: float, C: int, starts=None):
    """Kernel K8 over the component runs (``starts`` as for
    :func:`extents_cuda`)."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, ang=ang,
                           mag=mag, pix=pix)
    starts = _run_table(slot, C, starts, dev)
    newpix = torch.empty((n,), dtype=torch.float32, device=dev)
    out = torch.empty((C, TABLE_COLS), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_gate_moments", p(slot), p(xs), p(ys), p(ang), p(mag),
                   p(pix), p(tables), p(starts), n, C, fit_threads(n, C),
                   int(bool(dump_keep)), ctypes.c_float(cos_tol), p(newpix),
                   p(out), kernels.stream(dev))
    obs.launched("gate_moments")
    return newpix, out


def gate_pixels_cuda(slot, xs, ys, ang, pix, tables, dump_keep: bool,
                     cos_tol: float, C: int) -> torch.Tensor:
    """Kernel K9."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, ang=ang,
                           pix=pix)
    newpix = torch.empty((n,), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_gate_pixels", p(slot), p(xs), p(ys), p(ang), p(pix),
                   p(tables), n, C, int(bool(dump_keep)),
                   ctypes.c_float(cos_tol), p(newpix), kernels.stream(dev))
    obs.launched("gate_pixels")
    return newpix


# per kernel, device and stream: the epoch-tagged words of K9's consume
# form (csrc/lsd_fit.cu look_back) and of K10 (sum_pieces), and the epoch
# of their last call; calls on one stream run in order, so they share the
# words
_STATUS: dict = {}


def _status_words(kind: str, dev: torch.device, stream: int, count: int):
    """``count`` status words for kernel ``kind`` and a new epoch.  The
    buffer is zeroed where it is made (epoch 0 is never passed), so no call
    needs a memset."""
    key = (kind, dev.index, stream)
    words, epoch = _STATUS.get(key, (None, 0))
    epoch += 1
    if words is None or words.numel() < count or epoch >= 2**32:
        words = torch.zeros(max(count, 64), dtype=torch.int64, device=dev)
        epoch = 1
    _STATUS[key] = (words, epoch)
    return words, epoch


def consume_survivors_into(slot, xs, ys, idx_s, mag_s, ang_s, tables,
                           cos_tol: float, C: int, idx, mag, ang,
                           count) -> None:
    """Kernel K9's consume form into preallocated outputs: (n,) ``idx``,
    ``mag``, ``ang`` and a (1,) int32 ``count``, with no host sync (the
    first ``count`` entries are the survivors)."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, ang=ang_s,
                           mag=mag_s)
    kernels.check("idx_s", idx_s, torch.int64, (n,), dev)
    kernels.check("idx", idx, torch.int64, (n,), dev)
    for name, t in (("mag", mag), ("ang", ang)):
        kernels.check(name, t, torch.float32, (n,), dev)
    kernels.check("count", count, torch.int32, (1,), dev)
    if n == 0:
        count.zero_()
        return
    items = consume_items(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    words, epoch = _status_words(
        "consume", dev, stream, -(-n // (CONSUME_THREADS * items)))
    p = kernels.ptr
    kernels.launch("l3d_consume_survivors", p(slot), p(xs), p(ys), p(ang_s),
                   p(idx_s), p(mag_s), p(tables), n, C, items,
                   ctypes.c_float(cos_tol), p(words), words.numel(), epoch,
                   p(idx), p(mag), p(ang), p(count), ctypes.c_void_p(stream))
    obs.launched("consume_survivors")


def consume_survivors_cuda(slot, xs, ys, idx_s, mag_s, ang_s, tables,
                           cos_tol: float, C: int):
    """Kernel K9's consume form: one launch, then one host read of the
    count; returns views of the outputs' first ``count`` entries."""
    idx, mag, ang = (torch.empty_like(t) for t in (idx_s, mag_s, ang_s))
    count = torch.empty(1, dtype=torch.int32, device=slot.device)
    consume_survivors_into(slot, xs, ys, idx_s, mag_s, ang_s, tables,
                           cos_tol, C, idx, mag, ang, count)
    k = int(count) if idx.numel() else 0
    return idx[:k], mag[:k], ang[:k]


def _counts_cuda(slot, xs, ys, ang, pix, tables, C: int, bands,
                 cos_tol: float, starts) -> torch.Tensor:
    """Kernel K10 over the component runs: the p/2 column first where
    ``ang`` is given."""
    planes = dict(slot=slot, xs=xs, ys=ys, pix=pix)
    if ang is not None:
        planes["ang"] = ang
    n, dev = _check_pixels(C, tables, **planes)
    if n >= 2**24:
        raise ValueError(f"{n} pixels: kernel K10's float32 counts are "
                         f"exact below 2^24")
    bands = _bands_tensor(bands, dev)
    B, half = bands.shape[0], int(ang is not None)
    if B + half > MAX_BANDS:
        raise ValueError(f"bands: {B} bands and the p/2 column exceed "
                         f"{MAX_BANDS} columns")
    starts = _run_table(slot, C, starts, dev)
    out = torch.empty((C, B + half), dtype=torch.float32, device=dev)
    if C == 0:
        return out
    span = count_span(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    words, epoch = _status_words("counts", dev, stream,
                                 -(-n // span) * MAX_BANDS // 2)
    p = kernels.ptr
    kernels.launch("l3d_band_counts", p(slot), p(xs), p(ys),
                   ctypes.c_void_p(None) if ang is None else p(ang), p(pix),
                   p(tables), p(bands), p(starts), n, C, B, half, span,
                   ctypes.c_float(cos_tol), p(words), words.numel(), epoch,
                   p(out), ctypes.c_void_p(stream))
    obs.launched("rescue_counts" if half else "band_counts")
    return out


def band_counts_cuda(slot, xs, ys, pix, tables, C: int, bands=SYM_BANDS,
                     starts=None) -> torch.Tensor:
    """Kernel K10 over the component runs (``starts`` as for
    :func:`extents_cuda`)."""
    return _counts_cuda(slot, xs, ys, None, pix, tables, C, bands, 0.0,
                        starts)


def rescue_counts_cuda(slot, xs, ys, ang, pix, tables, C: int, bands,
                       cos_tol: float, starts=None) -> torch.Tensor:
    """Kernel K10's rescue form, one launch (``starts`` as for
    :func:`extents_cuda`)."""
    return _counts_cuda(slot, xs, ys, ang, pix, tables, C, bands, cos_tol,
                        starts)


def extents_cuda(slot, xs, ys, pix, tables, C: int,
                 starts=None) -> torch.Tensor:
    """Kernel K11 over the component runs: ``starts`` is their table
    (:func:`run_starts`).  Each real component must be one contiguous run,
    as in the detector's list; when ``starts`` is not given, the wrapper
    checks that (:func:`check_runs`) and builds the table from ``slot``."""
    n, dev = _check_pixels(C, tables, slot=slot, xs=xs, ys=ys, pix=pix)
    starts = _run_table(slot, C, starts, dev)
    out = torch.empty((C, 4), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("l3d_extents", p(slot), p(xs), p(ys), p(pix), p(tables),
                   p(starts), n, C, p(out), kernels.stream(dev))
    obs.launched("extents")
    return out


# ---------------------------------------------------------------------------
# the entry points: kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------

def moments(slot, xs, ys, mag, pix, C: int, starts=None) -> torch.Tensor:
    """``starts``: the run table, as for :func:`extents`."""
    if slot.is_cuda:
        return moments_cuda(slot, xs, ys, mag, pix, C, starts)
    return moments_plain(slot, xs, ys, mag, pix, C)


def gate_pixels(slot, xs, ys, ang, pix, tables, dump_keep: bool,
                cos_tol: float, C: int) -> torch.Tensor:
    if slot.is_cuda:
        return gate_pixels_cuda(slot, xs, ys, ang, pix, tables, dump_keep,
                                cos_tol, C)
    return gate_pixels_plain(slot, xs, ys, ang, pix, tables, dump_keep,
                             cos_tol, C)


def consume_survivors(slot, xs, ys, idx_s, mag_s, ang_s, tables,
                      cos_tol: float, C: int):
    """``(idx, mag, ang)`` of the pixels that the consume gate (``tables``,
    K9's test on ``ang_s`` with ``pix = 1``) does not take, in list order;
    their count is ``idx.numel()``."""
    if slot.is_cuda:
        return consume_survivors_cuda(slot, xs, ys, idx_s, mag_s, ang_s,
                                      tables, cos_tol, C)
    return consume_survivors_plain(slot, xs, ys, idx_s, mag_s, ang_s, tables,
                                   cos_tol, C)


def gate_moments(slot, xs, ys, ang, mag, pix, tables, dump_keep: bool,
                 cos_tol: float, C: int, starts=None):
    """``(newpix, moments)``: :func:`gate_pixels`, then :func:`moments` of
    the gated pixels; ``starts`` as for :func:`extents`."""
    if slot.is_cuda:
        return gate_moments_cuda(slot, xs, ys, ang, mag, pix, tables,
                                 dump_keep, cos_tol, C, starts)
    newpix = gate_pixels_plain(slot, xs, ys, ang, pix, tables, dump_keep,
                               cos_tol, C)
    return newpix, moments_plain(slot, xs, ys, mag, newpix, C)


def extents(slot, xs, ys, pix, tables, C: int,
            starts=None) -> torch.Tensor:
    """``starts``: the run table (:func:`run_starts`), which the kernel's
    wrapper checks and builds from ``slot`` when it is not given."""
    if slot.is_cuda:
        return extents_cuda(slot, xs, ys, pix, tables, C, starts)
    return extents_plain(slot, xs, ys, pix, tables, C)


def band_counts(slot, xs, ys, pix, tables, C: int, bands=SYM_BANDS,
                starts=None) -> torch.Tensor:
    """Pixel counts of every component in each band; ``bands`` is a (B, 4)
    tensor or nested sequence, the default the 4 symmetric width cuts;
    ``starts``: the run table, as for :func:`extents`."""
    if slot.is_cuda:
        return band_counts_cuda(slot, xs, ys, pix, tables, C, bands, starts)
    return band_counts_plain(slot, xs, ys, pix, tables, C, bands)


def rescue_counts(slot, xs, ys, ang, pix, tables, C: int, bands,
                  cos_tol: float, starts=None) -> torch.Tensor:
    """The rescue cascade's counts, (C, B + 1): column 0 the pixels that
    K9's gate keeps at ``cos_tol`` in the band ``|w_proj - mid| <= width /
    2`` (none where width <= 0), columns 1.. those of :func:`band_counts`;
    ``starts``: the run table, as for :func:`extents`."""
    if slot.is_cuda:
        return rescue_counts_cuda(slot, xs, ys, ang, pix, tables, C, bands,
                                  cos_tol, starts)
    return rescue_counts_plain(slot, xs, ys, ang, pix, tables, C, bands,
                               cos_tol)
