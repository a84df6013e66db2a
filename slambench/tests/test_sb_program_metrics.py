"""The readers of the program's own trace (``rec["program"]``, written by
``program.phase``) on hand-made phases, and the traced record gaining
that phase alone: with a program that traces, ``trace_record`` leaves
every other key of the record as it was."""

import types

import pytest
import torch

from slambench import plan, program, session

MS = 1_000_000      # ns


def _read(name, rec):
    return plan.load_reader(name)(rec)


def _scan(t, perception=5, mapping=None, loop=None, lm=None, tick=None):
    """A scan of the per-scan view starting at ``t`` ms: its graphs' device
    intervals laid end to end (ms each)."""
    p = [t * MS, (t + perception) * MS]
    m = [p[1], p[1] + mapping * MS] if mapping else None
    end = m[1] if m else p[1]
    lp = [end, end + loop * MS] if loop else None
    return {"scan": t, "host": {}, "perception": p, "mapping": m, "loop": lp,
            "lm": lm or [], "map_lm": [], "keyframe": bool(m),
            "loop_tick": tick}


def _program(scans, window, receipts=()):
    return {"program": {"window_ns": [window[0] * MS, window[1] * MS],
                        "scans": scans, "spans": [],
                        "receipt_ns": list(receipts)}}


def test_graph_idle_pct_counts_the_gaps():
    # Graphs busy 0-5, 5-9 (mapping), 20-25; window 0-40: 26 of 40 ms idle
    # (9-20 and 25-40), the overlapping interval counted once.
    scans = [_scan(0, mapping=4), _scan(20), _scan(21, perception=2)]
    assert _read("graph_idle_pct", _program(scans, (0, 40))) == \
        pytest.approx(100.0 * 26 / 40)
    assert _read("graph_idle_pct", {"program": None}) is None


def test_lm_past_convergence_reads_the_iterations_after_done():
    # Iterations end 1 ms apart; done first holds at iteration 7 of 12, so
    # the last 5 iterations' 5 ms ran past convergence; a scan that never
    # converged counts 0.
    lm = [[(100 + k) * MS, k >= 6] for k in range(12)]
    never = [[(200 + k) * MS, False] for k in range(12)]
    rec = _program([_scan(0, lm=lm)], (0, 300))
    assert _read("lm_past_convergence_ms", rec) == pytest.approx(5.0)
    rec = _program([_scan(0, lm=lm), _scan(50, lm=never)], (0, 300))
    assert _read("lm_past_convergence_ms", rec) == pytest.approx(2.5)


def test_pose_held_is_what_follows_the_pose():
    # A closing tick: the pose finished at 5 ms waits for the mapping
    # graph (14 ms), the loop graph (60 ms) and the copy (0.5 ms).
    tick = {"detected": 1, "verify": [[20 * MS, 30 * MS, True]],
            "resolve": [40 * MS, 75 * MS], "gn": [], "closed": True}
    rec = _program([_scan(0, mapping=14, loop=60, tick=tick)], (0, 100),
                   receipts=[(5 + 14 + 60 + 0.5) * MS])
    assert _read("pose_held_ms", rec) == pytest.approx(74.5)
    assert _read("resolve_ms", rec) == pytest.approx(35.0)
    assert _read("loop_accept_share", rec) == 1.0
    # A replay phase has no receipts.
    assert _read("pose_held_ms", _program([_scan(0)], (0, 10))) is None


def test_loop_readers_are_null_without_their_ticks():
    rejected = {"detected": 3, "verify": [[1, 2, False], [3, 4, False]],
                "resolve": None, "gn": [], "closed": False}
    rec = _program([_scan(0, loop=3, tick=rejected), _scan(10)], (0, 20))
    assert _read("resolve_ms", rec) is None          # no closing tick
    assert _read("loop_accept_share", rec) == 0.0
    rec = _program([_scan(0), _scan(10)], (0, 20))
    assert _read("resolve_ms", rec) is None
    assert _read("loop_accept_share", rec) is None   # none verified


def test_idle_gaps_are_named_by_what_the_host_did():
    # Graphs 0-5 and 20-25 ms; the host received the pose at 6, staged the
    # next scan 7-18 inside its call 6.5-19.5: the 15 ms gap is the
    # staging's, the 15 ms one after the last graph the harness's.
    p = _program([_scan(0), _scan(20)], (0, 40))["program"]
    p["spans"] = [
        {"name": "process_scan", "start_ns": 6.5 * MS, "end_ns": 19.5 * MS},
        {"name": "stage_scan", "start_ns": 7 * MS, "end_ns": 18 * MS}]
    assert program.idle_gaps(p) == [["stage_scan", pytest.approx(15.0)],
                                    ["harness", pytest.approx(15.0)]]


class _Run:
    """A stand-in for ``session.Run`` on the CPU: scans counted, each call
    1 ms of host and 2 ms of device time, a mapping tick every 3rd scan;
    the latency client of the program phase finds room for 3 scans."""

    def __init__(self, engine):
        self.system = types.SimpleNamespace(engine=engine, streams=1,
                                            device=torch.device("cpu"))
        self.next = 0
        self.left = 3
        self.map_at, self.loop_at, self.close_at = set(), set(), set()

    def _take(self, n):
        first = self.next
        self.next += n
        self.map_at.update(i for i in range(first, self.next) if i % 3 == 0)
        return n

    def latency(self, seconds, scans=None, closes=False):
        return [10.0] * self._take(scans or 4), 0.04

    def device_calls(self, scans):
        n = self._take(scans)
        return [1.0] * n, [2.0] * n

    def replay(self, seconds, lead, scans=None):
        return self._take(scans or 6), 0.06

    def room(self):
        return self.left > 0

    def step(self):
        self.left -= 1
        self._take(1)
        return torch.eye(4)


class _Trace:
    def __init__(self):
        self.calls = []

    def on(self):
        self.calls.append("on")

    def off(self):
        self.calls.append("off")

    def drain(self):
        self.calls.append("drain")
        return {"spans": [], "records": [], "scans": [], "dropped": {}}


NEW = ("graph_idle_pct", "lm_past_convergence_ms", "pose_held_ms",
       "resolve_ms", "loop_accept_share")


def _traced(run, mode, lead=4):
    """What ``run.run_cell`` does in a traced run: the record, then the
    readers of the program's trace."""
    traffic = {"mode": mode, "lead": lead, "trace_handin_scans": 4,
               "trace_device_scans": 5, "trace_program_scans": 3}
    rec = session.trace_record(run, traffic, 3, 1)
    values = {name: _read(name, rec) for name in NEW}
    return rec, values


@pytest.mark.parametrize("mode", ("replay", "latency"))
def test_trace_record_adds_the_phase_alone(mode):
    """The same readings with and without a program that traces, but for
    ``rec["program"]``: None for a program without a tracer, and every
    reader of it null; the phase runs once, last."""
    plain, none = _traced(_Run(types.SimpleNamespace()), mode)
    trace = _Trace()
    traced, _ = _traced(_Run(types.SimpleNamespace(trace=trace)), mode)
    assert plain.pop("program") is None
    assert set(none.values()) == {None}
    got = traced.pop("program")
    assert trace.calls == ["on", "drain", "off", "drain"]
    assert set(got) >= {"window_ns", "handin_ns", "receipt_ns",
                        "idle_gaps", "scans"}
    assert len(got["receipt_ns"]) == (3 if mode == "latency" else 0)
    keys = {"mode", "streams", "host_ms", "device_ms", "map_moved",
            "loop_moved", "close_moved", "profile", "phases"}
    if mode == "latency":
        keys |= {"handin_ms", "handin_map", "handin_loop", "handin_close"}
    assert set(plain) == set(traced) == keys
    for k in keys - {"profile", "phases"}:
        assert plain[k] == traced[k], k
    assert list(traced["phases"]) == (["handin"] if mode == "latency"
                                      else []) + ["device", "profile",
                                                  "program"]
