"""Edges inserted and deleted in the ticks completed in the window over
the window's seconds, in millions a second (host clock)."""


def read(ctx):
    if not ctx["iterations"]:
        return None
    return ctx["work"] / ctx["window_s"] / 1e6
