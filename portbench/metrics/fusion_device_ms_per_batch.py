"""fusion_device_ms_per_batch.serve: the device time of the kernels, copies and
sets launched inside the program's ``model.fusion`` spans, over the spanned
capture's batches (``portbench/spans.py``)."""

from portbench import spans


def read(capture):
    return spans.reading(capture, "fusion_device_ms_per_batch")
