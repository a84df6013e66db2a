"""The engine's tracer, and device traces (port of
``sc_lego_loam_tpu/utils/profiling.py``, grown into the port's tracer).

``StageTimer`` is the tracer's host half: spans (name, start and end in
``time.perf_counter_ns()``, the parent span, the scan index) in a
preallocated buffer, written out only by ``drain``.  An engine holds one as
``engine.trace``, off until ``on()``: while it is off a span costs one
attribute test and records nothing; ``on()`` and ``off()`` work on a
running engine.  While it is on, each span is also a ``torch.profiler``
range named ``scloam.<span>``, so a profiler session shows the program's
names.  On a CUDA device the host spans cover the launches, which return
before the device runs them; the device half is ``graphs.ProbeRing``, the
records of the ``probe`` kernels captured into the step graphs (``SITES``),
which ``drain`` converts onto the host spans' clock and joins to them scan
by scan (``scan_view``).  ``drain`` hands both out on ``torch.profiler``'s
host clock, which is not ``perf_counter_ns`` but the Unix time of
``time.time_ns()`` (``profiler_clock``), so that the program's spans and
records line up with a profiler session's events.

``summary`` and ``table`` aggregate the spans per name (the JAX package's
``StageTimer``; ``record`` adds a sample by hand).  ``device_trace`` wraps
``torch.profiler``; nothing opens one by default, because after a first
profiler session every later kernel launch of the process is slower.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

# The device records' sites, in id order (graphs.probe).  Per scan:
# perception begin, after the frontend and the de-skew, after the features,
# each odometry LM iteration's end [done], end; on a mapping tick: begin,
# after the submap and the scan's downsampling, each scan-to-map LM
# iteration's end [done], end [keyframe inserted]; on a loop tick: begin,
# after detection [run_sc + 2 run_rs], each verification body's begin and
# end [accepted], the re-solve body's begin and end, each GN iteration's
# end [converged], end [closed].
SITES = (
    "perception.begin", "perception.frontend", "perception.features",
    "perception.lm_iter", "perception.end",
    "mapping.begin", "mapping.submap", "mapping.lm_iter", "mapping.end",
    "loop.begin", "loop.detect", "loop.verify_begin", "loop.verify_end",
    "loop.resolve_begin", "loop.resolve_end", "loop.gn_iter", "loop.end")
SITE_ID = {name: i for i, name in enumerate(SITES)}

# The engines' host spans: the root, then its children.
ROOT_SPANS = ("process_scan", "process_scans")
GRAPHS = ("perception", "mapping", "loop")


class _Off:
    """The span of a tracer that is off: a context that does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_record_function = None


class _Span:
    __slots__ = ("timer", "slot", "range")

    def __init__(self, timer: "StageTimer", name: str):
        global _record_function
        t = timer
        self.timer = t
        self.slot = slot = t._head
        t._head += 1
        if slot < t.capacity:
            t._name[slot] = t._id(name)
            t._parent[slot] = t._open[-1] if t._open else -1
            t._scan[slot] = t.scan
            t._end[slot] = -1
        if _record_function is None:
            from torch.profiler import record_function
            _record_function = record_function
        self.range = _record_function("scloam." + name)

    def __enter__(self):
        t = self.timer
        t._open.append(self.slot)
        self.range.__enter__()
        if self.slot < t.capacity:
            t._start[self.slot] = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        t = self.timer
        self.range.__exit__(*exc)
        t._open.pop()
        if self.slot < t.capacity:
            t._end[self.slot] = end
            t._seconds[self.slot] = (end - t._start[self.slot]) * 1e-9
        return False


def profiler_clock(brackets: int = 20):
    """(offset ns, error ns): ``torch.profiler``'s host clock (Unix time,
    ``time.time_ns()``) minus ``time.perf_counter_ns()``, from the tightest
    of ``brackets`` reads of the one between two reads of the other, and
    that bracket's half-width."""
    best = None
    for _ in range(brackets):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[1] - best[0]:
            best = (a, b, r)
    a, b, r = best
    return r - (a + b) // 2, (b - a + 1) // 2


class StageTimer:
    """The tracer's host half (module docstring).  ``capacity`` spans are
    kept until ``drain``; later ones are counted and dropped.  ``probes``
    (a ``graphs.ProbeRing``) is the device half that ``on``, ``off`` and
    ``drain`` drive too.  A timer made on its own is on; an engine's is
    made off."""

    def __init__(self, capacity: int = 1 << 16, on: bool = True,
                 probes=None):
        self.capacity = capacity
        self.probes = probes
        self.enabled = False
        self.scan = -1             # the scan index the next spans carry
        self._start = np.zeros(capacity, np.int64)
        self._end = np.zeros(capacity, np.int64)
        self._seconds = np.zeros(capacity, np.float64)
        self._name = np.zeros(capacity, np.int32)
        self._parent = np.zeros(capacity, np.int64)
        self._scan = np.zeros(capacity, np.int64)
        self._names: list = []
        self._ids: dict = {}
        self._head = 0             # spans opened since the last drain
        self._open: list = []      # slots of the open spans, innermost last
        if on:
            self.on()

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self._names)
            self._names.append(name)
        return i

    def on(self):
        """Record from here on (host spans and the device's probes)."""
        if self.probes is not None:
            self.probes.set(True)
        self.enabled = True

    def off(self):
        self.enabled = False
        if self.probes is not None:
            self.probes.set(False)

    def stage(self, name: str):
        """A context recording one span, nested in the spans open now."""
        if not self.enabled:
            return _OFF
        return _Span(self, name)

    def record(self, name: str, seconds: float):
        """A span of ``seconds`` ending now, taken by the caller."""
        slot = self._head
        self._head += 1
        if slot < self.capacity:
            end = time.perf_counter_ns()
            self._name[slot] = self._id(name)
            self._parent[slot] = self._open[-1] if self._open else -1
            self._scan[slot] = self.scan
            self._start[slot] = end - int(seconds * 1e9)
            self._end[slot] = end
            self._seconds[slot] = seconds

    def _closed(self) -> np.ndarray:
        n = min(self._head, self.capacity)
        return np.flatnonzero(self._end[:n] >= 0)

    def summary(self, skip_first: int = 1) -> dict:
        """Per-name stats (seconds) of the spans held, skipping each name's
        first ``skip_first`` (warm-up) samples."""
        slots = self._closed()
        out = {}
        for i, name in enumerate(self._names):
            xs = self._seconds[slots[self._name[slots] == i]]
            if len(xs) == 0:
                continue
            a = xs[skip_first:] if len(xs) > skip_first else xs
            out[name] = {
                "n": len(a),
                "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "total": float(a.sum()),
            }
        return out

    def table(self, skip_first: int = 1) -> str:
        rows = ["stage                     n     mean     p50      p95    total"]
        for name, s in sorted(self.summary(skip_first).items(),
                              key=lambda kv: -kv[1]["total"]):
            rows.append(
                f"{name:<22} {s['n']:5d} {s['mean']*1e3:7.2f}ms "
                f"{s['p50']*1e3:7.2f}ms {s['p95']*1e3:7.2f}ms "
                f"{s['total']:7.2f}s")
        return "\n".join(rows)

    def drain(self) -> dict:
        """Everything recorded since the last drain, and empty the buffers.
        Synchronizes the device and converts its records onto the host
        spans' clock (``graphs.ProbeRing.drain``), then both onto the
        profiler's (``profiler_clock``).  Returns ``spans`` (name,
        start_ns, end_ns, parent: an index into ``spans`` or -1, scan),
        ``records`` (site, t_ns, value), ``offset_ns`` (``%globaltimer``
        minus the profiler's clock) and ``error_ns`` of the conversion,
        ``drift_ns`` (``graphs.ProbeRing.drain``), ``host_offset_ns`` (the
        profiler's clock minus ``perf_counter_ns``, for a caller's own
        stamps), ``dropped`` (spans, records) and ``scans``, the per-scan
        view (``scan_view``).  Call it between calls into the engine: a
        span open now is dropped."""
        host, host_err = profiler_clock()
        slots = self._closed()
        index = {int(s): k for k, s in enumerate(slots)}
        spans = [{"name": self._names[self._name[s]],
                  "start_ns": int(self._start[s]) + host,
                  "end_ns": int(self._end[s]) + host,
                  "parent": index.get(int(self._parent[s]), -1),
                  "scan": int(self._scan[s])} for s in slots]
        dropped_spans = max(0, self._head - self.capacity)
        self._head = 0
        self._open = []
        dev = {"records": [], "offset_ns": 0, "error_ns": 0, "dropped": 0,
               "drift_ns": 0}
        if self.probes is not None:
            dev = self.probes.drain()
        records = [(site, t + host, v) for site, t, v in dev["records"]]
        out = {"spans": spans, "records": records,
               "offset_ns": dev["offset_ns"] - host,
               "error_ns": dev["error_ns"] + host_err,
               "drift_ns": dev["drift_ns"], "host_offset_ns": host,
               "dropped": {"spans": dropped_spans,
                           "records": dev["dropped"]}}
        roots = [s for s in spans if s["name"] in ROOT_SPANS]
        begins = sum(1 for r in records if r[0] == "perception.begin")
        if (self.probes is not None and not dropped_spans
                and not dev["dropped"] and begins != len(roots)):
            raise RuntimeError(
                f"trace: {begins} perception graphs ran on the device "
                f"against {len(roots)} calls into the engine")
        out["scans"] = scan_view(spans, records, self.probes is not None)
        return out


def _interval(marks: dict, graph: str):
    b, e = marks.get(graph + ".begin"), marks.get(graph + ".end")
    return [b, e] if b is not None and e is not None else None


def scan_view(spans: list, records: list, device: bool = True) -> list:
    """Per scan: ``host`` (each child span of the call: [start_ns,
    end_ns]; ``call`` the call itself), the device intervals of the
    ``perception``, ``mapping`` and ``loop`` graphs ([begin_ns, end_ns] on
    the host clock, None where the graph did not run), ``lm`` and
    ``map_lm`` ([end_ns, done] of each LM iteration), ``keyframe``, and
    ``loop_tick`` (None, or ``detected`` (run_sc + 2 run_rs),
    ``verify`` ([begin_ns, end_ns, accepted] of each verification run),
    ``resolve`` ([begin_ns, end_ns] or None), ``gn`` ([end_ns, converged]
    of each GN iteration) and ``closed``).  On one stream the records come
    in the order the device ran them, so each perception ``begin`` opens
    the next scan, paired in order with the calls (``device`` False: the
    calls alone)."""
    calls = [k for k, s in enumerate(spans) if s["name"] in ROOT_SPANS]
    children: dict = {k: {} for k in calls}
    for s in spans:
        if s["parent"] in children:
            children[s["parent"]][s["name"]] = [s["start_ns"], s["end_ns"]]
    dev_scans, cur = [], None
    for site, t, v in records:
        if site == "perception.begin":
            cur = {"marks": {}, "lm": [], "map_lm": [], "keyframe": False,
                   "tick": None}
            dev_scans.append(cur)
        if cur is None:
            continue
        graph, what = site.split(".")
        if what in ("begin", "end"):
            cur["marks"][site] = t
        if site == "perception.lm_iter":
            cur["lm"].append([t, bool(v)])
        elif site == "mapping.lm_iter":
            cur["map_lm"].append([t, bool(v)])
        elif site == "mapping.end":
            cur["keyframe"] = bool(v)
        elif graph == "loop":
            tick = cur["tick"]
            if site == "loop.begin" or tick is None:
                tick = cur["tick"] = {"detected": 0, "verify": [],
                                      "resolve": None, "gn": [],
                                      "closed": False}
            if site == "loop.detect":
                tick["detected"] = int(v)
            elif site == "loop.verify_begin":
                tick["verify"].append([t, None, False])
            elif site == "loop.verify_end" and tick["verify"]:
                tick["verify"][-1][1:] = [t, bool(v)]
            elif site == "loop.resolve_begin":
                tick["resolve"] = [t, None]
            elif site == "loop.resolve_end" and tick["resolve"]:
                tick["resolve"][1] = t
            elif site == "loop.gn_iter":
                tick["gn"].append([t, bool(v)])
            elif site == "loop.end":
                tick["closed"] = bool(v)
    n = len(calls) if not device else min(len(calls), len(dev_scans))
    out = []
    for k in range(n):
        call = spans[calls[k]]
        host = dict(children[calls[k]])
        host["call"] = [call["start_ns"], call["end_ns"]]
        scan = {"scan": call["scan"], "host": host}
        if device:
            d = dev_scans[k]
            scan.update({g: _interval(d["marks"], g) for g in GRAPHS})
            scan.update(lm=d["lm"], map_lm=d["map_lm"],
                        keyframe=d["keyframe"], loop_tick=d["tick"])
        out.append(scan)
    return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card); writes ``<logdir>/trace.json`` (Chrome trace format) and yields
    the profiler, whose ``key_averages()`` the caller may read after the
    block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
