"""(e) A traced run's phases cover fixed stretches of the drive: with a
stand-in engine whose calls take different host times, ``trace_record``
starts and ends each phase at the same scans, and reads the same loop
ticks in them."""

import time
import types

import numpy as np
import pytest
import torch

from slambench import session

TRAFFIC = {"mode": "latency", "lead": 4, "trace_handin_scans": 11,
           "trace_device_scans": 19, "trace_program_scans": 13}


class _Trace:
    def on(self):
        pass

    def off(self):
        pass

    def drain(self):
        return {"spans": [], "records": [], "scans": [], "dropped": {}}


class _System:
    """A stand-in for ``session.System`` on the CPU: call ``i`` sleeps
    ``delay(i)`` s; a mapping tick on every 3rd scan, a loop tick on every
    9th, which closes a loop on every 18th."""

    def __init__(self, delay):
        self.delay, self.n = delay, 0
        self.streams, self.device = 1, torch.device("cpu")
        self.engine = types.SimpleNamespace(trace=_Trace())

    def step(self, drive, i):
        time.sleep(self.delay(i))
        self.n = i + 1
        return torch.eye(4)

    def ticks(self):
        return (self.n + 2) // 3, (self.n + 8) // 9

    def closed(self):
        return (self.n + 17) // 18


def _record(delay, mode):
    drive = types.SimpleNamespace(scans=np.zeros((200, 1, 1, 3)))
    run = session.Run(_System(delay), drive)
    run.warm_up(7)
    rec = session.trace_record(run, dict(TRAFFIC, mode=mode), 5, 2)
    return rec


@pytest.mark.parametrize("mode", ("latency", "replay"))
def test_phases_start_and_end_at_fixed_scans(mode):
    fast = _record(lambda i: 0.0, mode)
    slow = _record(lambda i: 0.002 * (i % 3), mode)
    assert fast["phases"] == slow["phases"]
    handin = [[7, 17]] if mode == "latency" else []
    start = 18 if mode == "latency" else 7
    assert list(fast["phases"].values()) == handin + [
        [start, start + 18], [start + 19, start + 25],
        [start + 26, start + 38]]
    for k in ("map_moved", "loop_moved", "close_moved") + (
            ("handin_map", "handin_loop", "handin_close")
            if mode == "latency" else ()):
        assert fast[k] == slow[k], k
    # The device phase holds loop ticks that closed and ones that did not.
    kinds = set(zip(fast["loop_moved"], fast["close_moved"]))
    assert {(True, True), (True, False)} <= kinds
