"""mfu.serve and .train: the reference's operations of the light capture's
batches or steps over its seconds and the card's dense peak."""


def read(capture):
    return None if capture is None else capture.mfu_pct()
