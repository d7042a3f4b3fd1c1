"""The window's train events of every seed over its seconds (host clock):
the rate that ``train_events_per_s`` reads in the cells where the host
paces it steadily enough for a bound."""


def read(ctx):
    return ctx.get("events_per_s") or None
