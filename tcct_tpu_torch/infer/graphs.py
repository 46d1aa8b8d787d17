"""A bucket's serving forward as CUDA graphs split at the ``tcct::`` calls.

A single-card predictor (``infer/predictor.py``) enqueues hundreds of small
eager ops a batch, and the host cannot launch them as fast as the card runs
them.  So on the first batch of a bucket it runs the forward once eagerly
(the warm-up: kernels built, K4's packed weights cached, the batch's maps)
and once under capture, into a :class:`Tape`; every later batch of the
bucket copies its uint8 input into the tape's static input and replays it.

The capture is one pass of the forward (logits, argmax, cast) on a side
stream, all of its graphs in one private memory pool.  It is cut into
segments:

- at every ``tcct::`` op call: the segment before it is closed, the call is
  noted (its ``out`` overload, its arguments, and outputs made for it:
  ``ops/kernels/library.py::define_out``), and the next op opens the next
  segment.  At replay the call is made eagerly through the same op, so it
  stays a host op with its shapes in a profiler's trace and its kernel
  writes the outputs that the next segment reads;
- at every span's entry and exit (``utils/tracing.py::borders``), whether
  tracing is on or off: at replay the span is opened, with the attributes
  it had, and closed there, so each segment's ``cudaGraphLaunch`` lies in
  the ``model.*`` and ``mixer.*`` spans its ops ran in eagerly (with
  tracing off the span does nothing).

The segments replay in capture order, as graphs that share a pool must.
Replayed, a batch runs the eager forward's kernels on the same inputs in
the same order: its maps are the eager maps bit for bit.  The tape holds
every ``tcct::`` call's inputs and outputs and the pool, about one forward's
activations.  A forward that calls a ``tcct::`` op without an ``out``
overload cannot be captured.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tcct_tpu_torch.ops.kernels import library
from tcct_tpu_torch.utils import tracing


class Tape:
    """A bucket's captured forward: its static input ``x`` (uint8, the
    batch's shape), the static output ``out`` (the uint8 maps, overwritten
    by each replay), and the steps of a replay.  ``segments``: the graphs;
    ``tcct_calls``: the eager ``tcct::`` calls; ``segment_spans``: for each
    graph, in replay order, the names of the spans open around it;
    ``spans``: how many times a replay opens each span, by name."""

    def __init__(self, x: torch.Tensor, out: torch.Tensor, rec: "_Recorder"):
        self.x, self.out = x, out
        self._steps = rec.steps
        self._graphs = rec.graphs  # kept alive with the pool they share
        self.segments = len(rec.graphs)
        self.tcct_calls = rec.calls
        self.segment_spans: List[Tuple[str, ...]] = rec.segment_spans
        self.spans: Dict[str, int] = dict(rec.span_counts)

    @torch.inference_mode()
    def replay(self) -> torch.Tensor:
        """Enqueue the forward on the current stream from :attr:`x`'s
        contents; returns :attr:`out`."""
        for step in self._steps:
            step()
        return self.out


class _Recorder(TorchDispatchMode):
    """Runs the forward under capture, cutting it into segments at the
    ``tcct::`` calls and at the spans' borders."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # no torch.compile runs under the mode: without this, its handler is
        # wrapped to disable TorchDynamo, whose import at the first capture
        # of a process takes seconds
        return False

    def __init__(self):
        super().__init__()
        self.pool = torch.cuda.graph_pool_handle()
        self.graph = None  # the open segment
        self.graphs: list = []
        self.steps: List[Callable[[], None]] = []
        self.calls = 0
        self.names: List[str] = []  # the spans open at capture
        self.segment_spans: List[Tuple[str, ...]] = []
        self.span_counts: collections.Counter = collections.Counter()
        self.spans: list = []  # the spans a replay has open

    def open(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def close(self) -> None:
        if self.graph is not None:
            graph, self.graph = self.graph, None
            graph.capture_end()
            self.graphs.append(graph)
            self.segment_spans.append(tuple(self.names))
            self.steps.append(graph.replay)

    def abandon(self) -> None:
        """End an open capture after a failure, dropping the segment."""
        graph, self.graph = self.graph, None
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:
                pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "tcct":
            return self._call(func, args, kwargs)
        if self.graph is None and func.is_view:
            # a view launches nothing and needs no segment; an op that may
            # return a view or a copy (aten::to, aten::reshape) is run again
            # under capture where it copied
            got = func(*args, **kwargs)
            if _aliases(got, args):
                return got
        if self.graph is None:
            self.open()
        return func(*args, **kwargs)

    def _call(self, func, args, kwargs):
        if func not in library.OUT or kwargs:
            raise NotImplementedError(f"{func} has no out overload: a forward calling it "
                                      "cannot be captured")
        self.close()
        out_op, outputs = library.OUT[func]
        got = outputs(*args)
        outs = got if isinstance(got, tuple) else (got,)
        self.steps.append(functools.partial(out_op, *args, *outs))
        self.calls += 1
        return got

    def border(self, name: str, attrs: dict) -> "_Border":
        return _Border(self, name, attrs)


def _aliases(got, args) -> bool:
    """Whether every tensor of ``got`` shares the storage of a tensor of
    ``args``."""
    inputs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
    outs = got if isinstance(got, (list, tuple)) else (got,)
    return all(isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in inputs
               for t in outs)


class _Border:
    """A span's entry and exit as a capture notes them: each closes the open
    segment and adds the span's opening (with its attributes) or closing to
    the replay's steps."""

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec, name, attrs = self.rec, self.name, self.attrs
        rec.close()
        rec.names.append(name)
        rec.span_counts[name] += 1

        def enter():
            s = tracing.span(name, **attrs)
            s.__enter__()
            rec.spans.append(s)

        rec.steps.append(enter)

    def __exit__(self, *exc):
        rec = self.rec
        rec.close()
        rec.names.pop()
        rec.steps.append(lambda: rec.spans.pop().__exit__(None, None, None))
        return False


def capture(forward: Callable[[torch.Tensor], torch.Tensor],
            x_u8: torch.Tensor) -> Tuple[torch.Tensor, Tape]:
    """``forward(x_u8)`` (the eager forward: a uint8 batch on a card to its
    uint8 maps) run once eagerly and once under capture, both on a side
    stream; returns the eager maps and the :class:`Tape`."""
    main = torch.cuda.current_stream(x_u8.device)
    side = torch.cuda.Stream(x_u8.device)
    side.wait_stream(main)
    rec = _Recorder()
    with torch.cuda.stream(side):
        try:
            maps = forward(x_u8)
            x = torch.empty_like(x_u8)
            with rec, tracing.borders(rec.border):
                out = forward(x)
            rec.close()
        except BaseException:
            rec.abandon()
            raise
        finally:
            main.wait_stream(side)
    return maps, Tape(x, out, rec)
