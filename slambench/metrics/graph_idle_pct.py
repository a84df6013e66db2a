"""graph_idle_pct (%): the share of the program phase's window (the
harness's start of the phase to its closing synchronize, on the host
clock) in which no step graph ran on the device, from the union of the
perception, mapping and loop graphs' ``begin``-``end`` records of the
program's own trace (``rec["program"]``, ``slambench/program.py``)."""

from slambench import program


def read(rec):
    p = rec.get("program")
    if not p:
        return None
    w0, w1 = p["window_ns"]
    busy = program.graph_intervals(p)
    if not busy or w1 <= w0:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in busy) / (w1 - w0))
