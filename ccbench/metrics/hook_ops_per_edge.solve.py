"""``WorkCounters.hook_ops`` of the traced window's solves over their
edges: an exact count of the edge hooks the CC engine evaluated."""


def read(ctx):
    c = ctx["counters"]
    return c["hook_ops"] / c["hook_edges"] if c.get("hook_edges") else None
