"""The 90th percentile of every tick's latency in the window, insert call
to labels current, in milliseconds (host clock)."""
import numpy as np


def read(ctx):
    lat = ctx["latencies_s"]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
