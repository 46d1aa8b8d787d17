"""edge_idle_ms_per_volume.serve: the card's idle milliseconds between the
spanned capture's first and last volume that no ``serve.dispatch`` span
covers (copies, maps back, the volume's edges, the client) over its volumes
(``portbench/spans.py``)."""

from portbench import spans


def read(capture):
    return spans.reading(capture, "edge_idle_ms_per_volume")
