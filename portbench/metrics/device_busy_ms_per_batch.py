"""device_busy_ms_per_batch.serve: the card's busy time in the light capture
over its batches."""


def read(capture):
    return None if capture is None else capture.busy_ms_per_unit()
