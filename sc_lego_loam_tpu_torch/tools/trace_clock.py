"""Checks of the tracer's clock on the card (``utils/profiling.py``,
``graphs.ProbeRing``), one JSON line:

- ``host_clock``: whether ``time.perf_counter_ns()`` is the clock of
  ``torch.profiler``'s host events: ``perf_counter_ns`` read first and last
  inside each of 20 ``record_function`` ranges, against the range's start
  and end in the session (``raw_lead_ns``: the first read minus the
  range's start), and the same after ``utils.profiling.profiler_clock``'s
  conversion (``lead_ns``, ``lag_ns``: the reads' distance inside the
  range's ends; a few microseconds on one clock);
- ``probe_vs_profiler``: each of 20 eager probes' time as the tracer's
  ``drain`` hands it out against its ``probe`` kernel's start in the same
  session (``diff_ns``), beside the conversion's stated error
  (``error_ns``) and the drift of its offset between ``on()`` and the
  drain, and each host span's start against its ``scloam.`` range's;
- ``globaltimer``: the resolution seen for ``%globaltimer``: the greatest
  common divisor and the smallest non-zero step of the raw device times of
  probes run back to back, eagerly and replayed in a CUDA graph, and the
  share of zero steps.

    python -m sc_lego_loam_tpu_torch.tools.trace_clock
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from .. import graphs
from ..utils.profiling import StageTimer, profiler_clock


def _stats(x) -> dict:
    a = np.asarray(x, np.int64)
    return {"min": int(a.min()), "median": int(np.median(a)),
            "max": int(a.max())}


def host_clock(n: int = 20) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    inside = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with record_function(f"trace_clock.{i}"):
                a = time.perf_counter_ns()
                time.sleep(0.001)
                inside.append((a, time.perf_counter_ns()))
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("trace_clock."):
            ranges.setdefault(int(e.name().split(".")[1]),
                              (e.start_ns(), e.end_ns()))
    raw = [inside[i][0] - s for i, (s, _) in ranges.items()]
    host, err = profiler_clock()
    lead = [inside[i][0] + host - s for i, (s, _) in ranges.items()]
    lag = [e - inside[i][1] - host for i, (_, e) in ranges.items()]
    return {"ranges": len(ranges),
            "same_clock": all(0 <= x < 1_000_000 for x in raw),
            "raw_lead_ns": _stats(raw), "profiler_offset_ns": host,
            "profiler_offset_error_ns": err, "lead_ns": _stats(lead),
            "lag_ns": _stats(lag),
            "converted_inside": all(-err <= x < 1_000_000
                                    for x in lead + lag)}


def probe_vs_profiler(device, n: int = 20) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ring = graphs.ProbeRing(device)
    trace = StageTimer(probes=ring)
    trace.drain()               # the clock's first point
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            trace.scan = i
            with trace.stage("process_scan"), graphs.probing(ring):
                graphs.probe("perception.begin")
            torch.cuda.synchronize(device)
            time.sleep(0.002)
    trace.off()
    got = trace.drain()
    events = list(prof.profiler.kineto_results.events())
    starts = sorted(e.start_ns() for e in events
                    if e.name().startswith("probe"))
    ranges = sorted(e.start_ns() for e in events
                    if e.name() == "scloam.process_scan"
                    and e.device_type() != DeviceType.CUDA)
    times = [t for _, t, _ in got["records"]]
    diff = [t - s for t, s in zip(times, starts)]
    span_diff = [s["start_ns"] - r for s, r in zip(got["spans"], ranges)]
    return {"probes": len(times), "kernels": len(starts),
            "diff_ns": _stats(diff) if diff else None,
            "span_start_minus_range_start_ns": _stats(span_diff)
            if span_diff else None,
            "error_ns": got["error_ns"], "drift_ns": got["drift_ns"],
            "offset_ns": got["offset_ns"],
            "within_error": bool(diff) and len(times) == len(starts)
            and all(abs(d) <= got["error_ns"] for d in diff)}


def _steps(raw) -> dict:
    d = np.diff(np.asarray(raw, np.int64))
    pos = d[d > 0]
    return {"probes": len(raw),
            "gcd_ns": int(math.gcd(*pos.tolist())) if len(pos) else None,
            "min_step_ns": int(pos.min()) if len(pos) else None,
            "median_step_ns": float(np.median(d)) if len(d) else None,
            "zero_share": float((d == 0).mean()) if len(d) else None}


def globaltimer(device, n: int = 200) -> dict:
    ring = graphs.ProbeRing(device, capacity=4 * n)

    def burst():
        with graphs.probing(ring):
            for _ in range(n):
                graphs.probe("perception.lm_iter")

    out = {}
    ring.set(True)
    burst()
    torch.cuda.synchronize(device)
    out["eager"] = _steps(ring.buf[:ring.count(), 0].cpu().tolist())
    ring.drain()
    stream = torch.cuda.Stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        burst()
    graph.replay()
    torch.cuda.synchronize(device)
    out["graph"] = _steps(ring.buf[:ring.count(), 0].cpu().tolist())
    ring.drain()
    ring.set(False)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("trace_clock: no CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    out = {"device": torch.cuda.get_device_name(device),
           "globaltimer": globaltimer(device),
           "host_clock": host_clock(),
           "probe_vs_profiler": probe_vs_profiler(device)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
