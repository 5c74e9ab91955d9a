"""Spans and counters of the port: where a scene's time goes, by stage.

``span(name, owner)`` marks a stage of the work.  It records only while
a ``torch.profiler`` profile is recording or inside :func:`recording`;
otherwise it returns one shared null context and reads no clock.  While
recording, a span enters ``torch.profiler.record_function(name)`` (so it
shows in the profiler's trace, nested under the caller's spans and above
the kernels it launches) and keeps ``(name, parent, start, end)`` in
memory, ``start`` and ``end`` from ``time.time_ns()``: the profiler's
clock up to one offset per process (its chrome trace's ``ts`` is the
Unix time in microseconds less its ``baseTimeNanoseconds``).

The spans of one ``Line3D`` share one :class:`Record`, a scene with its
own ``id``: the pipeline's public methods pass the pipeline as ``owner``,
and a span opened inside another (the stages in ``models/`` and ``ops/``)
joins the record of the innermost open span, as its child.  A top-level
span without an owner joins the newest record when that has no owner
either, else starts one.  :func:`records` gives the last ``KEEP``
records, :func:`summary` one record's times and launches by span name.

Kernel launches are counted by :func:`launched`, which every wrapper in
``ops/`` calls: it increments ``ops.kernels.LAUNCHES[wrapper]`` and, while
recording, the launches of the innermost open span.  Host syncs by stage
are read from the device trace (device-to-host copies launched inside a
span), so they have no counter here; line bundling's counts (iterations,
accepted steps, launches) are ``Line3D.bundle_stats``, and the plain loop
that serves CPU tensors also opens one ``recon.bundle.lm_iteration`` span
an iteration; the interval sweep's (clusters, members, intervals, the
clusters past the kernel's shared memory) are ``Line3D.sweep_stats``.

Spans belong to the thread that runs the pipeline; the module keeps one
stack of open spans.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import time
import weakref

import torch
import torch.autograd.profiler as _profiler

from .ops import kernels

KEEP = 64                                   # records kept, newest last

_NULL = contextlib.nullcontext()
_recording = 0                              # depth of recording() blocks
_open: list = []                            # open spans, innermost last
_records: collections.deque = collections.deque(maxlen=KEEP)
_by_owner: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_ids = itertools.count()


class Span:
    """One span of a record: its ``name``, the index of its ``parent`` in
    the record's ``spans`` (-1 for a top-level span), ``start`` and ``end``
    in ``time.time_ns()`` (``end`` None while open) and the kernel
    ``launches`` made while it was the innermost open span, by wrapper."""

    __slots__ = ("name", "parent", "start", "end", "launches")

    def __init__(self, name: str, parent: int, start: int):
        self.name, self.parent, self.start = name, parent, start
        self.end = None
        self.launches: dict = {}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, parent={self.parent}, "
                f"start={self.start}, end={self.end})")


class Record:
    """The spans of one scene, in the order they opened."""

    __slots__ = ("id", "owned", "spans")

    def __init__(self, owned: bool):
        self.id = next(_ids)
        self.owned = owned
        self.spans: list[Span] = []


@contextlib.contextmanager
def recording():
    """Records spans without a profiler, for the block."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def span(name: str, owner=None):
    """A context manager that marks one stage (see the module's
    docstring); ``owner`` is the pipeline whose record a top-level span
    joins."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, owner)


def spanned(name: str):
    """Decorates a function whose whole call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _record_for(owner) -> tuple[Record, int]:
    """The record a new span joins, and its parent's index."""
    if _open:
        rec, index = _open[-1]
        return rec, index
    if owner is not None:
        rec = _by_owner.get(owner)
        if rec is None:
            rec = _by_owner[owner] = Record(owned=True)
            _records.append(rec)
        return rec, -1
    if _records and not _records[-1].owned:
        return _records[-1], -1
    rec = Record(owned=False)
    _records.append(rec)
    return rec, -1


class _Open:
    __slots__ = ("name", "owner", "function", "entry")

    def __init__(self, name: str, owner):
        self.name, self.owner = name, owner

    def __enter__(self):
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        rec, parent = _record_for(self.owner)
        rec.spans.append(Span(self.name, parent, time.time_ns()))
        self.entry = (rec, len(rec.spans) - 1)
        _open.append(self.entry)
        return self

    def __exit__(self, *exc):
        rec, index = self.entry
        rec.spans[index].end = time.time_ns()
        # an exception may leave inner spans open above this one
        while _open and _open.pop() is not self.entry:
            pass
        self.function.__exit__(*exc)
        return False


def launched(wrapper: str) -> None:
    """Counts one kernel launch by ``wrapper``: in ``kernels.LAUNCHES``,
    and while recording in the innermost open span."""
    kernels.LAUNCHES[wrapper] += 1
    if _open:
        rec, index = _open[-1]
        counts = rec.spans[index].launches
        counts[wrapper] = counts.get(wrapper, 0) + 1


def records() -> list[Record]:
    """The last ``KEEP`` records, oldest first."""
    return list(_records)


def clear() -> None:
    """Forgets every record."""
    _records.clear()
    _by_owner.clear()


def summary(record: Record) -> dict:
    """Per span name of ``record``'s closed spans: ``count``,
    ``total_ms``, ``self_ms`` (the duration less the part its child spans
    cover) and ``launches`` (kernel launches made while a span of that
    name was the innermost open one)."""
    spans = record.spans
    children: dict = {}
    for s in spans:
        if s.parent >= 0 and s.end is not None:
            children.setdefault(s.parent, []).append((s.start, s.end))
    out: dict = {}
    for i, s in enumerate(spans):
        if s.end is None:
            continue
        covered, reach = 0, s.start
        for a, b in sorted(children.get(i, ())):
            a, b = max(a, reach), min(b, s.end)
            if b > a:
                covered += b - a
                reach = b
        row = out.setdefault(s.name, dict(count=0, total_ms=0.0, self_ms=0.0,
                                          launches=0))
        row["count"] += 1
        row["total_ms"] += 1e-6 * (s.end - s.start)
        row["self_ms"] += 1e-6 * (s.end - s.start - covered)
        row["launches"] += sum(s.launches.values())
    return out
