"""The least device time the problem needs over the device time the
traced solves took, in percent. The least bytes are counted from the
input, whatever implements the solve: each edge's two int32 ends read
once (8 B) and each vertex's int32 label written once (4 B), at the
card's HBM rate from ``peaks.json``. The device time is the seconds in
which an operation ran on the device over the traced solves, from the
``torch.profiler`` trace; nothing for a device the table does not hold,
or a trace that holds no device event."""
import json
from pathlib import Path


def read(ctx):
    peaks = json.loads((Path(__file__).resolve().parents[1]
                        / "peaks.json").read_text())
    peak = peaks.get(ctx["device_kind"])
    p = ctx["profile"]
    if peak is None or not p or p["busy_s"] <= 0 or not p["iterations"]:
        return None
    least_bytes = 8 * p["work"] + 4 * ctx["num_nodes"] * p["iterations"]
    return 100.0 * least_bytes / peak["hbm_bytes_per_s"] / p["busy_s"]
