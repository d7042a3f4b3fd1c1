"""Host milliseconds per ``observe`` inside the program's
``zebra.protocol`` span (the eval protocol: messages stored, pending ones
committed through the GRU), over the traced steps (``spans.reduce``); None
where the program records no such span."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, ["zebra.protocol"], "host_s", "zebra.observe", 1e3)
