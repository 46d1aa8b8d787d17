"""decoder_device_ms_per_batch.serve: the device time of the kernels, copies and
sets launched inside the program's ``model.decoder`` spans, over the spanned
capture's batches (``portbench/spans.py``)."""

from portbench import spans


def read(capture):
    return spans.reading(capture, "decoder_device_ms_per_batch")
