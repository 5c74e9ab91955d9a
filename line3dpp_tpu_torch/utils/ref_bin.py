"""Reader and writer of reference Line3D++ ``.bin`` files (host numpy).

The reference saves its final model as a boost *binary archive* of
``std::vector<L3DPP::FinalLine3D>`` (save3DLinesAsBIN line3D.cc:2690-2711,
serializeToFile serialization.h:38-46), and each view's detected segments
as one of ``DataArray<float4>``.  This module parses and writes both
formats natively (no boost required), byte for byte as
``line3dpp_tpu.utils.ref_bin`` does, so existing Line3D++ results and
segment caches can be loaded and the port's results read by Line3D++.

Wire format (little-endian, reverse-engineered from the shipped golden
.bin files and the serialize() member functions in segment3D.h:99-177 /
commons.h:126-130; validated byte-exactly against the golden .txt):

* header: u64 signature length, ``serialization::archive``, u16 library
  version (10), four u8 type sizes (sizeof int/long/float/double);
* the first time each class TYPE occurs, a 5-byte class-info block is
  written: u8 tracking flag + u32 class version (tracked objects — only
  the top-level vector here — additionally carry a u32 object id);
* every collection instance: u64 element count + u32 item version;
* ``Segment3D``: f32 length, u8 valid, 3x f64 P1, 3x f64 P2, 3x f64 dir;
* ``Segment2D``: u32 camID, u32 segID;
* ``LineCluster3D``: Segment3D + list<Segment2D> + u32 reference view;
* ``FinalLine3D``: list<Segment3D> + LineCluster3D.

The reference stores residuals as (camID, segID) only — 2D endpoint
coordinates are resolved from live views at save-TXT time — so imported
residual rows carry zeros in the coordinate columns.
"""

from __future__ import annotations

import struct

import numpy as np

from .writers import FinalLine3D

_SIGNATURE = b"serialization::archive"
_LIB_VERSION = 10


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0
        self.seen: set = set()

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.d, self.o)
        self.o += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def class_info(self, tag: str):
        """Consume the first-occurrence class-info block for type ``tag``."""
        if tag in self.seen:
            return
        self.seen.add(tag)
        tracking = self.take("B")
        if tracking:
            self.take("I")          # object id
        self.take("I")              # class version

    def collection_header(self, tag: str) -> int:
        self.class_info(tag)
        count = self.take("Q")
        self.take("I")              # item version
        return count

    def segment3d(self):
        self.class_info("Segment3D")
        _length = self.take("f")
        _valid = self.take("B")
        vals = self.take("9d")
        return np.array(vals[0:6])  # [P1 | P2]; dir is redundant

    def segment2d(self):
        self.class_info("Segment2D")
        cam = self.take("I")
        seg = self.take("I")
        return cam, seg


def _open_archive(path: str) -> tuple[_Reader, bytes]:
    """Read + validate the boost binary-archive header; return the reader
    positioned at the first object."""
    with open(path, "rb") as fh:
        data = fh.read()
    r = _Reader(data)

    siglen = r.take("Q")
    sig = data[r.o:r.o + siglen]
    if sig != _SIGNATURE:
        raise ValueError(f"{path}: not a boost serialization archive")
    r.o += siglen
    libver = r.take("H")
    if libver < 8:
        raise ValueError(f"{path}: unsupported archive library version "
                         f"{libver}")
    sizes = r.take("4B")
    if tuple(sizes) != (4, 8, 4, 8):
        raise ValueError(f"{path}: unexpected primitive sizes {sizes}")
    return r, data


def load_reference_bin(path: str) -> list[FinalLine3D]:
    """Parse a reference Line3D++ result ``.bin`` into FinalLine3D records."""
    r, data = _open_archive(path)

    n_lines = r.collection_header("vector<FinalLine3D>")
    out = []
    for _ in range(n_lines):
        r.class_info("FinalLine3D")
        n_seg = r.collection_header("list<Segment3D>")
        segs = np.stack([r.segment3d() for _ in range(n_seg)]) \
            if n_seg else np.zeros((0, 6))
        r.class_info("LineCluster3D")
        _cluster_line = r.segment3d()
        n_res = r.collection_header("list<Segment2D>")
        res = np.zeros((n_res, 6))
        for i in range(n_res):
            cam, seg = r.segment2d()
            res[i, 0] = cam
            res[i, 1] = seg
        _ref_view = r.take("I")
        out.append(FinalLine3D(segments3d=segs, residuals=res))
    if r.o != len(data):
        raise ValueError(f"{path}: {len(data) - r.o} trailing bytes "
                         "after the last record — layout mismatch")
    return out


def load_reference_segments_bin(path: str) -> np.ndarray:
    """Parse a reference per-image 2D segment cache.

    The reference caches each view's detected segments as a boost binary
    archive of ``DataArray<float4>`` named
    ``segments_L3D++_<camID>_<WxH>_<maxsegs>.bin`` (line3D.cc:296-309,
    362-366; DataArray serialize member dataArray.h:352-374).  The stored
    coordinates are already upscaled to the original image resolution and
    length-filtered/top-K sorted by length descending (line3D.cc:320-360).

    Returns an (n, 4) float64 array of [x1 y1 x2 y2] rows.
    """
    r, data = _open_archive(path)

    # DataArray<float4> class info; tracked objects carry a u32 object id
    r.class_info("DataArray<float4>")
    width = r.take("I")                 # segments stored (dataArray.h:338)
    height = r.take("I")                # 1 for segment caches
    real_width = r.take("I")            # width padded to 32-byte pitch
    _pitch_cpu = r.take("Q")
    _stride_cpu = r.take("Q")
    _pitch_gpu = r.take("Q")
    _stride_gpu = r.take("Q")
    n = real_width * height
    if n:
        # make_array<float4>: per-element serialize (4 f32), one class-info
        # block for float4 before the first element (dataArray.h:63-70)
        r.class_info("float4")
        flat = np.frombuffer(data, dtype="<f4", count=4 * n, offset=r.o)
        r.o += 16 * n
    else:
        flat = np.zeros((0,), np.float32)
    if r.o != len(data):
        raise ValueError(f"{path}: {len(data) - r.o} trailing bytes "
                         "after the pixel array — layout mismatch")
    segs = flat.reshape(height, real_width, 4)[:, :width]
    return segs.reshape(-1, 4).astype(np.float64)


class _Writer:
    """Boost binary-archive writer mirroring :class:`_Reader`: class-info
    blocks are emitted on the first occurrence of each type tag only."""

    def __init__(self):
        self.out = bytearray()
        self.seen: set = set()
        self.out += struct.pack("<Q", len(_SIGNATURE)) + _SIGNATURE
        self.out += struct.pack("<H4B", _LIB_VERSION, 4, 8, 4, 8)

    def put(self, fmt: str, *vals):
        self.out += struct.pack("<" + fmt, *vals)

    def class_info(self, tag: str, tracked: bool = False):
        if tag in self.seen:
            return
        self.seen.add(tag)
        if tracked:
            self.put("BII", 1, 0, 0)     # tracking, object id, class version
        else:
            self.put("BI", 0, 0)         # untracked, class version

    def collection_header(self, tag: str, count: int, tracked: bool = False):
        self.class_info(tag, tracked)
        self.put("QI", count, 0)         # element count, item version

    def segment3d(self, seg: np.ndarray):
        self.class_info("Segment3D")
        p, q = np.asarray(seg[0:3], np.float64), np.asarray(seg[3:6],
                                                            np.float64)
        d = q - p
        n = float(np.linalg.norm(d))
        if n > 0:
            d = d / n
        self.put("f", np.float32(n))
        self.put("B", 1)
        self.put("9d", *p, *q, *d)

    def segment2d(self, cam: int, seg: int):
        self.class_info("Segment2D")
        self.put("II", int(cam), int(seg))


def save_bin_boost(path: str, lines: list[FinalLine3D]) -> None:
    """Write the final model as a reference-compatible boost binary archive
    of ``std::vector<FinalLine3D>`` — the exact inverse of
    :func:`load_reference_bin` (save3DLinesAsBIN line3D.cc:2690-2711), so
    downstream Line3D++ tooling can consume our ``.bin`` directly.

    The cluster's underlying Segment3D (ignored by readers that only need
    the collinear segments) is synthesized as the span from the first
    segment's P1 to the last segment's P2; the cluster reference view is
    the first residual's camID (0 when there are no residuals)."""
    w = _Writer()
    w.collection_header("vector<FinalLine3D>", len(lines), tracked=True)
    for line in lines:
        w.class_info("FinalLine3D")
        segs = np.asarray(line.segments3d, np.float64).reshape(-1, 6)
        w.collection_header("list<Segment3D>", len(segs))
        for seg in segs:
            w.segment3d(seg)
        w.class_info("LineCluster3D")
        if len(segs):
            span = np.concatenate([segs[0, 0:3], segs[-1, 3:6]])
        else:
            span = np.zeros(6)
        w.segment3d(span)
        res = np.asarray(line.residuals).reshape(-1, 6)
        w.collection_header("list<Segment2D>", len(res))
        for r in res:
            w.segment2d(r[0], r[1])
        w.put("I", int(res[0, 0]) if len(res) else 0)
    with open(path, "wb") as fh:
        fh.write(bytes(w.out))


def save_reference_segments_bin(path: str, segments: np.ndarray) -> None:
    """Write a per-image 2D segment cache in the reference's on-disk format
    (the inverse of :func:`load_reference_segments_bin`), so detections can
    be exported back into an existing Line3D++ workspace."""
    segments = np.asarray(segments, np.float32).reshape(-1, 4)
    n = len(segments)
    # float4 pitch alignment to 32 bytes (dataArray.h:110-118)
    real_width = n + (n % 2)
    padded = np.zeros((real_width, 4), np.float32)
    padded[:n] = segments

    out = bytearray()
    out += struct.pack("<Q", len(_SIGNATURE)) + _SIGNATURE
    out += struct.pack("<H4B", _LIB_VERSION, 4, 8, 4, 8)
    # DataArray<float4> class info: tracked (object id 0) + class version 0,
    # matching the golden archives' convention for top-level objects
    out += struct.pack("<BII", 1, 0, 0)
    pitch = real_width * 16
    out += struct.pack("<III", n, 1, real_width)
    out += struct.pack("<QQQQ", pitch, real_width, 0, 0)
    if real_width:
        out += struct.pack("<BI", 0, 0)          # float4: untracked, v0
        out += padded.astype("<f4").tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(out))
