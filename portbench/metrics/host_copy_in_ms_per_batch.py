"""host_copy_in_ms_per_batch.serve: the host's milliseconds in the program's
``serve.copy_in`` spans (the tail's padding and the uint8 copy to the card)
over the span pass's batches, at the untraced window's pace
(``portbench/spans.py``)."""

from portbench import spans


def read(capture):
    return spans.reading(capture, "host_copy_in_ms_per_batch")
