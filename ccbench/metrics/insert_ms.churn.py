"""The median of the Solver.insert span (the dynamic engine's insert route), each ending in a
synchronise, over the traced run's window, in milliseconds."""
import statistics


def read(ctx):
    times = ctx["spans"].get("insert")
    return statistics.median(times) * 1e3 if times else None
