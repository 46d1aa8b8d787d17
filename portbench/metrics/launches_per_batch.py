"""launches_per_batch.serve: device kernels in the light capture over its
batches."""


def read(capture):
    return None if capture is None else capture.launches_per_unit()
