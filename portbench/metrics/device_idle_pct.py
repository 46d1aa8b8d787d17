"""device_idle_pct.serve and .train: the share of the light capture's wall time
with no kernel, copy or set on the card."""


def read(capture):
    return None if capture is None else capture.idle_pct()
