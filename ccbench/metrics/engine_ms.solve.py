"""The median of the plan.run() span (the CC engine), each ending in a
synchronise, over the traced run's window, in milliseconds."""
import statistics


def read(ctx):
    times = ctx["spans"].get("run")
    return statistics.median(times) * 1e3 if times else None
