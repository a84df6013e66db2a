"""pose_held_ms (ms): per scan of a latency client, the client's receipt
of the fused pose (host clock) minus the device end of that scan's
perception graph (its ``end`` record, converted onto the host clock): how
long a finished pose waits behind the mapping and loop graphs and the
copy; the 95th percentile over the phase's scans, from the program's own
trace (``rec["program"]``)."""

import numpy as np


def read(rec):
    p = rec.get("program")
    if not p or not p.get("receipt_ns"):
        return None
    held = [(r - s["perception"][1]) * 1e-6
            for r, s in zip(p["receipt_ns"], p["scans"])
            if s.get("perception")]
    return float(np.percentile(held, 95)) if held else None
