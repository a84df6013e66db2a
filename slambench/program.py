"""The program's own trace in a traced run (``rec["program"]``).

A phase of its own, the last of ``session.trace_record``'s: a fixed count
of scans in the cell's own mode, unprofiled, with the engine's tracer
(``engine.trace``: host spans in ``process_scan``, probe records inside
the step graphs, on one clock) on for the phase and drained after it.
Its scans go in through ``Run.step``, so they are published and judged
like every other.  A program without the tracer gives ``None``, and
every reader of it reads null.
"""

from __future__ import annotations

import json
import sys
import time

from . import session


def stamped(run, scans: int):
    """The latency client over ``scans`` scans, each scan's hand-in and
    receipt of its pose as ``time.perf_counter_ns()``."""
    stamps = []
    while run.room() and len(stamps) < scans:
        h0 = time.perf_counter_ns()
        pose = run.step()
        pose.cpu()
        stamps.append((h0, time.perf_counter_ns()))
    return stamps


def graph_intervals(program: dict) -> list:
    """The union of the step graphs' device intervals of a program phase,
    clipped to its window: sorted [start_ns, end_ns] pairs on the host
    clock."""
    w0, w1 = program["window_ns"]
    spans = sorted((max(iv[0], w0), min(iv[1], w1))
                   for s in program["scans"]
                   for iv in (s.get(g) for g in ("perception", "mapping",
                                                 "loop"))
                   if iv and iv[1] > w0 and iv[0] < w1)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(program: dict, top: int = 10) -> list:
    """The ``top`` longest stretches of the phase's window in which no step
    graph ran, each named by what the program's host did through most of
    it: at each instant the innermost host span open then (``harness``
    where none was), the name that holds the most of the gap: [name, ms].
    (The span open at a gap's start is always ``harness``: a gap begins
    when the device has finished what the host gave it.)"""
    w0, w1 = program["window_ns"]
    edges = [w0] + [x for iv in graph_intervals(program) for x in iv] + [w1]
    gaps = sorted(((edges[k], edges[k + 1])
                   for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]),
                  key=lambda g: g[0] - g[1])[:top]
    spans = program["spans"]

    def name(a, b):
        inside = [s for s in spans if s["start_ns"] < b and s["end_ns"] > a]
        cuts = sorted({a, b} | {t for s in inside
                                for t in (s["start_ns"], s["end_ns"])
                                if a < t < b})
        held: dict = {}
        for t0, t1 in zip(cuts, cuts[1:]):
            open_now = [s for s in inside
                        if s["start_ns"] <= t0 and s["end_ns"] >= t1]
            n = max(open_now, key=lambda s: s["start_ns"])["name"] \
                if open_now else "harness"
            held[n] = held.get(n, 0) + t1 - t0
        return max(held, key=held.get)

    return [[name(a, b), (b - a) * 1e-6] for a, b in gaps]


def phase(run, mode: str, scans: int, lead: int):
    """The program's own records over ``scans`` scans in the cell's own mode
    (a replay with its ``lead``, or the latency client with each scan's
    hand-in and receipt stamped), unprofiled: the engine's tracer on for
    the phase and drained after it (``utils/profiling.StageTimer.drain``:
    host spans, device records and the per-scan view on the profiler's
    host clock), with the phase's window (its start to its closing
    synchronize) and the stamps on the same clock.  None for a program
    without the tracer."""
    trace = getattr(run.system.engine, "trace", None)
    if trace is None or not hasattr(trace, "drain"):
        return None
    session.sync(run.system.device)
    trace.on()
    trace.drain()           # empty, and the clock's first point
    w0 = time.perf_counter_ns()
    stamps = []
    if mode == "latency":
        stamps = stamped(run, scans)
    else:
        run.replay(0, lead, scans=scans)
    w1 = time.perf_counter_ns()
    trace.off()
    program = trace.drain()
    host = program.get("host_offset_ns", 0)   # onto the drain's clock
    program.update(window_ns=[w0 + host, w1 + host],
                   handin_ns=[a + host for a, _ in stamps],
                   receipt_ns=[b + host for _, b in stamps])
    program["idle_gaps"] = idle_gaps(program)
    print("slambench: program idle gaps "
          + json.dumps(program["idle_gaps"]), file=sys.stderr, flush=True)
    return program
