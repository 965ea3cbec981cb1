"""The median of the Solver.open span (graph ingest), each ending in a
synchronise, over the traced run's window, in milliseconds."""
import statistics


def read(ctx):
    times = ctx["spans"].get("open")
    return statistics.median(times) * 1e3 if times else None
