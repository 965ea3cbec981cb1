"""The share of the traced window in which no operation ran on the
device, in percent, from the ``torch.profiler`` trace; nothing when the
trace holds no device event."""


def read(ctx):
    p = ctx["profile"]
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
