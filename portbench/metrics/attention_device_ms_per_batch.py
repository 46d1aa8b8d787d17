"""attention_device_ms_per_batch.serve: the device time of the kernels,
copies and sets launched inside the program's ``mixer.attention`` spans
(each call of an attention token mixer with its CRPE), over the spanned
capture's batches (``portbench/spans.py``).  None unless every batch of the
capture holds one such span for each MHCA block of the configuration."""

import bisect

from portbench import spans
from portbench.reference.attention_costs import mixers

SPAN = "mixer.attention"


def read(capture):
    spans.reading(capture, "vit_device_ms_per_batch")  # makes the span passes once
    got = getattr(capture, "spans", None)
    if got is None:
        return None
    return attention_ms_per_batch(got.spanned, got.device, mixers(capture.cell["config_file"]))


def attention_ms_per_batch(spanned, device, per_batch: int):
    """The device milliseconds of ``device``'s events (those launched within
    the ``serve.volume`` spans) whose launch, or start where the trace has
    none, lies in a :data:`SPAN` span, over the ``serve.batch`` spans; None
    unless each batch holds ``per_batch`` of them."""
    batches = sorted((s.start_ns, s.end_ns) for s in spanned if s.name == "serve.batch")
    att = sorted((s.start_ns, s.end_ns) for s in spanned if s.name == SPAN)
    if not batches:
        return None
    starts = [a for a, _ in att]
    for a, b in batches:
        if bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a) != per_batch:
            return None
    ns = 0
    for d in spans.within_volumes(spanned, device):
        i = bisect.bisect_right(starts, d.key_ns) - 1
        if i >= 0 and d.key_ns <= att[i][1]:
            ns += d.end_ns - d.start_ns
    return ns * 1e-6 / len(batches)
