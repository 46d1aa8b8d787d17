"""attention_roofline_pct.serve: the least time of a batch's attention
mixers (``reference/attention_costs.py``, from the configuration and the
traffic) over their device time a batch
(``attention_device_ms_per_batch.serve``)."""

from portbench import harness
from portbench.reference.attention_costs import batch_bound_s


def read(capture):
    ms = harness.reader("attention_device_ms_per_batch.serve")(capture)
    if not ms:
        return None
    cell = capture.cell
    return 100.0 * batch_bound_s(cell["config_file"], cell["traffic_file"]) * 1e3 / ms
