"""host_maps_back_ms_per_volume.serve: the host's milliseconds in the
program's ``serve.maps_back`` spans (the wait for the card and the class maps'
copy to the host) over the span pass's volumes, at the untraced window's pace
(``portbench/spans.py``)."""

from portbench import spans


def read(capture):
    return spans.reading(capture, "host_maps_back_ms_per_volume")
