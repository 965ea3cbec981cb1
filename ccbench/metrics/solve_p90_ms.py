"""The 90th percentile of every solve's latency in the window, call to
labels ready, in milliseconds (host clock)."""
import numpy as np


def read(ctx):
    lat = ctx["latencies_s"]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
