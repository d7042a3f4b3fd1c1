"""Host milliseconds per ``observe`` inside the program's ``zebra.fold``
span (the adjacency index rebuilt on the host and uploaded), over the
traced steps (``spans.reduce``); None where the program records no such
span."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, ["zebra.fold"], "host_s", "zebra.observe", 1e3)
