"""Spans of the serving path, on the clock of ``torch.profiler``'s traces.

A span is a named stretch of the host's time: its start and end, the span
it opened inside (``parent_id``), the request it belongs to
(``request_id``: every span of one served volume shares the id of its
``serve.volume`` span; a span opened outside every other span starts a new
request) and the few attributes its caller gave.  Spans are kept in memory
until :func:`drain` takes them, at most :data:`CAPACITY` of them: a server
that keeps tracing on drains regularly (about 58 spans a 61-scan volume at
batch 8, 362 with MPViT-Small's attention mixers), and :func:`dropped`
counts the spans a full buffer did not keep.

Serving with spans::

    from tcct_tpu_torch.utils import tracing

    tracing.enable()
    maps = predictor.predict_volume(volume)
    spans = tracing.drain()   # the recorded spans; the buffer is emptied
    tracing.disable()

The spans the program records (``infer/predictor.py``, ``models/ftc.py``,
``models/mpvit.py``):

- ``serve.volume`` (``scans``): ``predict_volume``, the request's root;
- ``serve.batch`` (``rows``, the real B-scans of the batch): one turn of
  ``predict_scans``' loop, holding ``serve.copy_in`` (the tail's padding and
  the uint8 copy to the device), ``serve.dispatch`` (``replayed``: whether
  the batch was replayed from its bucket's CUDA graphs, ``infer/graphs.py``;
  the host enqueueing the forward, the cast and the argmax), on a mesh
  ``serve.gather``, then the batch's maps copied into the volume's;
- ``serve.maps_back``: the wait for the device and the copy of the class
  maps to the host; ``serve.postprocess``: the resize to ``native_hw``;
- inside ``serve.dispatch``, an FTC model's ``model.cnn`` (the CrossCNN
  branch, or the fused block kernel's), ``model.vit`` (MPViT and its
  projections), ``model.fusion`` (the CNN projections and the fusion) and
  ``model.decoder`` (the head, the up-blocks and the aux heads); a replayed
  batch opens them around the graphs and ``tcct::`` calls that ran in them
  when its bucket was captured;
- inside ``model.vit``, ``mixer.attention`` (``tokens``, ``dim``, ``heads``):
  each call of an attention token mixer (``factor``, ``hydra``: the mixer
  and its CRPE), off a width shard; the MetaPool mixers record none.

Times are stamped with ``time.perf_counter_ns()`` and given by :func:`drain`
in Unix nanoseconds, through one ``(time.time_ns(), perf_counter_ns())``
pair read at :func:`enable`: the clock of a ``torch.profiler`` Chrome trace,
whose event at ``ts`` (microseconds) lies at ``ts * 1000 +
baseTimeNanoseconds``.  A span and a kernel of one trace compare directly.

Off (the default) :func:`span` reads one module flag and returns one
shared no-op context: no clock, no record, no call into the profiler.  On,
a span costs a few microseconds of the host's time.  Under ``torch.compile``
or ``torch.export`` a span is the no-op too.  Each thread keeps its own
stack of open spans; the buffer is the process's.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from time import perf_counter_ns
from typing import List, NamedTuple, Optional

import torch

_on = False
# while a capture notes the spans' borders (borders()): the capturing thread
# and the function it is handed each span's name and attributes with
_hook: Optional[tuple] = None
# tracing on, or borders noted: span() does more than return NO_SPAN
_active = False

# the most spans the buffer keeps between two drains (about 20 MB of them)
CAPACITY = 100_000


class Span(NamedTuple):
    """One drained span; ``start_ns`` and ``end_ns`` in Unix nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    request_id: int
    attrs: dict


# the context span() returns while tracing is off: one shared instance
# (a nullcontext, which torch.compile and torch.export trace through)
NO_SPAN = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.records: list = []  # (name, start, end, id, parent, request, attrs), perf ns
        self.dropped = 0  # spans not kept since enable(): the buffer was full
        self.offset_ns = 0  # Unix ns minus perf_counter ns, read at enable()
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.local = threading.local()


_state = _State()


class _Open:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "request_id", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_state.local, "stack", None)
        if stack is None:
            stack = _state.local.stack = []
        if stack:
            self.parent_id, self.request_id = stack[-1].span_id, stack[-1].request_id
        else:
            self.parent_id, self.request_id = None, next(_state.requests)
        self.span_id = next(_state.ids)
        stack.append(self)
        self.start = perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = perf_counter_ns()
        _state.local.stack.pop()
        if len(_state.records) >= CAPACITY:
            _state.dropped += 1
            return False
        _state.records.append((self.name, self.start, end, self.span_id, self.parent_id,
                               self.request_id, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` with ``attrs`` while tracing
    is on; :data:`NO_SPAN` while it is off.  Inside :func:`borders`, on its
    thread, the context that :func:`borders` was handed for ``name`` and
    ``attrs``."""
    if not _active:
        return NO_SPAN
    if torch.compiler.is_compiling():
        return NO_SPAN
    hook = _hook
    if hook is not None and hook[0] == threading.get_ident():
        return hook[1](name, attrs)
    if not _on:
        return NO_SPAN
    return _Open(name, attrs)


@contextlib.contextmanager
def borders(record):
    """While inside, on this thread, ``span(name, **attrs)`` returns
    ``record(name, attrs)`` (a context manager) whether tracing is on or
    off, and records nothing: a capture (``infer/graphs.py``) notes where
    the spans open and close, to open them with their attributes around
    its replays.  Other threads' spans are as before."""
    global _hook, _active
    _hook, _active = (threading.get_ident(), record), True
    try:
        yield
    finally:
        _hook, _active = None, _on


def enable() -> None:
    """Turn tracing on.  The clock pair that :func:`drain` converts with
    is read here, where tracing was off."""
    global _on, _active
    if not _on:
        a = perf_counter_ns()
        unix = time.time_ns()
        _state.offset_ns = unix - (a + perf_counter_ns()) // 2
        _state.dropped = 0
    _on = _active = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until :func:`drain`."""
    global _on, _active
    _on = False
    _active = _hook is not None


def dropped() -> int:
    """The spans not kept since tracing was last turned on, because the
    buffer already held :data:`CAPACITY` undrained spans."""
    return _state.dropped


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they ended,
    with their times in Unix nanoseconds; the buffer is emptied."""
    records, _state.records = _state.records, []
    off = _state.offset_ns
    return [Span(n, s + off, e + off, i, p, r, a) for n, s, e, i, p, r, a in records]
