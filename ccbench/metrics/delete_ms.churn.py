"""The median of the Solver.delete span (the dynamic engine's delete route), each ending in a
synchronise, over the traced run's window, in milliseconds."""
import statistics


def read(ctx):
    times = ctx["spans"].get("delete")
    return statistics.median(times) * 1e3 if times else None
