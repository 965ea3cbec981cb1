"""The session's ``WorkCounters.hook_ops`` over the traced window's ticks,
per edge inserted or deleted: an exact count of the dynamic engine's
edge hooks."""


def read(ctx):
    c = ctx["counters"]
    return c["hook_ops"] / c["updated_edges"] \
        if c.get("updated_edges") else None
