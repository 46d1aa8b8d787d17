"""host_dispatch_ms_per_batch.serve: the host's milliseconds in the program's
``serve.dispatch`` spans (enqueueing a batch's forward, cast and argmax) over
the span pass's batches, with no profiler, at the untraced window's pace
(``portbench/spans.py``)."""

from portbench import spans


def read(capture):
    return spans.reading(capture, "host_dispatch_ms_per_batch")
