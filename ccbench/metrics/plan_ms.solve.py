"""The median of the .plan("auto") span (the front door's decision), each ending in a
synchronise, over the traced run's window, in milliseconds."""
import statistics


def read(ctx):
    times = ctx["spans"].get("plan")
    return statistics.median(times) * 1e3 if times else None
