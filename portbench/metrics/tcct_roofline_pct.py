"""tcct_roofline_pct.serve and .train: the tcct:: calls' roofline bounds over
their device time, in the shaped capture."""


def read(capture):
    return None if capture is None else capture.tcct_roofline_pct()
