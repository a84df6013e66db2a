"""The system under test and the loops that drive it.

The port is driven only through ``SlamEngine.process_scan`` (one vehicle)
and ``BatchEngine.process_scans`` (a fleet of streams in lockstep); both
take host numpy scans and return the fused poses as device tensors.  A
drive with an IMU stream feeds a single engine the samples due by each
scan's end in one ``SlamEngine.push_imu_batch`` before the scan, inside
the same hand-in.  The harness reads the engines' host tick counters and,
after the window, the keyframe and loop-factor banks that ``correct``
judges.

Two modes, both closed loops of one client:

- replay: scans handed in back to back; the client waits on an event of
  the scan ``lead`` scans back, as a log reader with a bounded queue does,
  and never for its poses until the window closes with one
  ``torch.cuda.synchronize()``;
- latency: the client fetches each fused pose to the host before it hands
  in the next scan; a scan's latency runs from its hand-in to that pose on
  the host.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time

import numpy as np
import torch

from . import caster, devtrace

SCAN_PERIOD = caster.SCAN_PERIOD
# Device sleep before a call timed alone: ~25 ms on an H100, longer than
# the host takes to put any one call on the stream.
SLEEP = 50_000_000


def pipeline_config(groups: dict):
    """The port's ``PipelineConfig`` with every group's fields as the
    configuration file states them (lists become tuples)."""
    from sc_lego_loam_tpu_torch.config import PipelineConfig
    base = PipelineConfig()
    kw = {}
    for f in dataclasses.fields(PipelineConfig):
        cls = type(getattr(base, f.name))
        vals = {k: tuple(v) if isinstance(v, list) else v
                for k, v in groups[f.name].items()}
        kw[f.name] = cls(**vals)
    return PipelineConfig(**kw)


class System:
    """One ``SlamEngine`` (``streams`` 1) or one ``BatchEngine(n_seq=
    streams)``, on ``device``.  ``tf32`` switches TF32 matmuls on after
    the engine has switched them off: the control's lower precision."""

    def __init__(self, config: dict, device, tf32: bool = False):
        pc = pipeline_config(config["pipeline"])
        self.streams = int(config["streams"])
        self.kind = config["engine"]
        if self.kind == "single":
            from sc_lego_loam_tpu_torch.pipeline import SlamEngine
            self.engine = SlamEngine(pc, device=device)
        elif self.kind == "batch":
            from sc_lego_loam_tpu_torch.parallel.batch import BatchEngine
            self.engine = BatchEngine(pc, n_seq=self.streams, device=device)
        else:
            raise ValueError(f"unknown engine {self.kind!r}")
        if tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        self.device = torch.device(device)
        self.push_ms = {}          # scan -> host ms of its IMU push

    def step(self, drive: caster.Drive, i: int):
        """Hand in scan ``i`` of every stream; the fused pose(s), on the
        device.  With an IMU stream, first the samples due by the scan's
        end that no earlier scan pushed, in one batch (a single engine;
        ``plan`` refuses a fleet with the IMU on)."""
        t = i * SCAN_PERIOD
        imu = drive.imu
        if imu is not None:
            a, b = imu.ends[i - 1] if i else 0, imu.ends[i]
            if b > a:
                h0 = time.perf_counter()
                self.engine.push_imu_batch(imu.times[a:b], imu.rpy[a:b, 0],
                                           imu.acc[a:b, 0], imu.gyro[a:b, 0])
                self.push_ms[i] = (time.perf_counter() - h0) * 1e3
        if self.kind == "single":
            return self.engine.process_scan(drive.scans[i, 0],
                                            drive.valids[i, 0], t=t)
        return self.engine.process_scans(drive.scans[i], drive.valids[i],
                                          t=t)

    def ticks(self):
        """(a marker that moves on a mapping tick, loop ticks so far)."""
        e = self.engine
        if self.kind == "single":
            return e.map_ticks, e.loop_ticks
        return e.last_map_time, e.loop_ticks

    def closed(self) -> int:
        """Loop ticks that closed so far, over the streams: a device
        counter, read on the host (a synchronize)."""
        return int(self.engine.loops_closed.sum())

    def banks(self) -> list:
        """Per stream, the keyframe and loop-factor banks as numpy."""
        e = self.engine
        if self.kind == "single":
            kf, loops = e.m.kf, e.m.loops
            kf = type(kf)(*(x[None] for x in kf))
            loops = type(loops)(*(x[None] for x in loops))
        else:
            kf, loops = e.map.kf, e.loops
        counts = kf.count.cpu().numpy()
        L = loops.i.shape[1]
        lcount = np.minimum(loops.count.cpu().numpy(), L)
        out = []
        for s in range(self.streams):
            n, m = int(counts[s]), int(lcount[s])
            out.append({
                "poses6": kf.poses6[s, :n].double().cpu().numpy(),
                "times": kf.times[s, :n].double().cpu().numpy(),
                "odom_z": kf.odom_z[s, :n].double().cpu().numpy(),
                "li": loops.i[s, :m].long().cpu().numpy(),
                "lj": loops.j[s, :m].long().cpu().numpy(),
                "lz": loops.z[s, :m].double().cpu().numpy(),
            })
        return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """The scans handed in so far, their published poses, the scans on
    which a mapping or a loop tick ran and, of the scans of the traced
    phases that read it, those whose loop tick closed a loop."""

    def __init__(self, system: System, drive: caster.Drive):
        self.system, self.drive = system, drive
        self.poses = []              # device tensors, one a step
        self.map_at, self.loop_at, self.close_at = set(), set(), set()
        self.exhausted = False

    @property
    def next(self) -> int:
        return len(self.poses)

    def step(self):
        i = self.next
        m0, l0 = self.system.ticks()
        with torch.profiler.record_function(devtrace.HAND_IN):
            pose = self.system.step(self.drive, i)
        m1, l1 = self.system.ticks()
        if m1 != m0:
            self.map_at.add(i)
        if l1 != l0:
            self.loop_at.add(i)
        self.poses.append(pose)
        return pose

    def room(self) -> bool:
        if self.next < len(self.drive.scans):
            return True
        self.exhausted = True
        return False

    def warm_up(self, n: int):
        while self.next < n and self.room():
            self.step()
        sync(self.system.device)

    def replay(self, seconds: float, lead: int, scans: int | None = None):
        """Back to back until the host clock passes ``seconds`` (or
        ``scans`` scans); returns (scans, window s) over a window that
        ends with a synchronize."""
        dev = self.system.device
        cuda = dev.type == "cuda"
        events = collections.deque()
        first = self.next
        t0 = time.perf_counter()
        while self.room():
            if scans is None and time.perf_counter() - t0 >= seconds:
                break
            if scans is not None and self.next - first >= scans:
                break
            self.step()
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
                if len(events) > lead:
                    with torch.profiler.record_function(devtrace.WAIT):
                        events.popleft().synchronize()
        with torch.profiler.record_function(devtrace.WAIT):
            sync(dev)
        return self.next - first, time.perf_counter() - t0

    def _closes(self, before: int) -> int:
        """Mark the last scan if its loop tick closed; the count now."""
        now = self.system.closed()
        if now != before:
            self.close_at.add(self.next - 1)
        return now

    def latency(self, seconds: float, scans: int | None = None,
                closes: bool = False):
        """Each scan's pose fetched to the host before the next hand-in,
        until ``seconds`` (or ``scans`` scans); returns (hand-in to pose
        ms per scan, window s).  ``closes``: after each scan's latency is
        taken, read whether its loop tick closed."""
        lat = []
        first = self.next
        closed = self.system.closed() if closes else 0
        t0 = time.perf_counter()
        while self.room():
            if scans is None and time.perf_counter() - t0 >= seconds:
                break
            if scans is not None and self.next - first >= scans:
                break
            h0 = time.perf_counter()
            pose = self.step()
            with torch.profiler.record_function(devtrace.WAIT):
                pose.cpu()
            lat.append((time.perf_counter() - h0) * 1e3)
            if closes and self.next - 1 in self.loop_at:
                closed = self._closes(closed)
        return lat, time.perf_counter() - t0

    def device_calls(self, scans: int):
        """Each of ``scans`` calls timed alone on the device: a synchronize,
        a device sleep (so that the host has put the whole call on the
        stream before the device reaches it), then CUDA events around the
        call.  Returns (host ms of each call, device ms of each call; on
        the CPU, which has no events, the host ms again)."""
        host, events = [], []
        dev = self.system.device
        cuda = dev.type == "cuda"
        closed = self.system.closed()
        first = self.next
        while self.room() and self.next - first < scans:
            sync(dev)
            if self.next - 1 in self.loop_at:
                closed = self._closes(closed)
            if cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), \
                    torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP)
                e0.record()
            h0 = time.perf_counter()
            self.step()
            host.append((time.perf_counter() - h0) * 1e3)
            if cuda:
                e1.record()
                events.append((e0, e1))
        sync(dev)
        if self.next - 1 in self.loop_at:
            self._closes(closed)
        if not cuda:
            return host, list(host)
        return host, [a.elapsed_time(b) for a, b in events]

    def published(self) -> np.ndarray:
        """(n, streams, 4, 4) float64 poses of every scan handed in."""
        P = torch.stack(self.poses).double().cpu().numpy()
        return P.reshape(len(self.poses), self.system.streams, 4, 4)


def _kinds(run: Run, first: int, n: int):
    """Per scan first..first+n-1: (mapping tick, loop tick, closing tick)
    flags."""
    idx = range(first, first + n)
    return ([i in run.map_at for i in idx], [i in run.loop_at for i in idx],
            [i in run.close_at for i in idx])


def phase_bounds(run: Run, name: str, first: int, closed=None) -> list:
    """[first, last] scan of a traced phase that began at ``first`` and
    ended at ``run.next``, printed on stderr with the loop ticks among
    them and, where the phase read them (``closed``), those that closed."""
    last = run.next - 1
    ticks = sum(first <= i <= last for i in run.loop_at)
    said = "" if closed is None else f", {closed} closed"
    print(f"slambench: traced phase {name} scans {first}-{last}: "
          f"{ticks} loop ticks{said}", file=sys.stderr, flush=True)
    return [first, last]


def _closed(run: Run, first: int) -> int:
    return sum(i >= first for i in run.close_at)


def trace_record(run: Run, traffic: dict, profile_scans: int,
                 warm_scans: int) -> dict:
    """The traced run's readings in the mix ``traffic``'s mode, each phase
    over a fixed count of scans that the mix names, so that every program,
    fast or slow, reads the same stretch of the drive.  A latency cell
    first runs its client over ``trace_handin_scans`` scans (hand-in to
    pose per scan); then every cell times each of ``trace_device_scans``
    calls alone on the device (``Run.device_calls``); both phases read
    which loop ticks closed.  Then a ``torch.profiler`` session over
    ``profile_scans`` scans in the cell's own mode, after ``warm_scans``
    scans under the profiler unrecorded (the first replays of each graph
    under it are slow).  Under the profiler a graph launch costs the host
    far more than without it, so the session's idle share reads the
    profiler (PERF.md); its kernels are the program's.  Last, the
    program's own trace over ``trace_program_scans`` scans in the cell's
    own mode, unprofiled (``program.phase``).  ``rec["phases"]`` holds
    each phase's first and last scan."""
    from . import program

    mode, lead = traffic["mode"], int(traffic["lead"])
    rec = {"mode": mode, "streams": run.system.streams}
    phases = rec["phases"] = {}
    if mode == "latency":
        first = run.next
        rec["handin_ms"], _ = run.latency(
            0, scans=int(traffic["trace_handin_scans"]), closes=True)
        rec["handin_map"], rec["handin_loop"], rec["handin_close"] = _kinds(
            run, first, len(rec["handin_ms"]))
        phases["handin"] = phase_bounds(run, "handin", first,
                                        _closed(run, first))
    first = run.next
    rec["host_ms"], rec["device_ms"] = run.device_calls(
        int(traffic["trace_device_scans"]))
    rec["map_moved"], rec["loop_moved"], rec["close_moved"] = _kinds(
        run, first, len(rec["host_ms"]))
    phases["device"] = phase_bounds(run, "device", first,
                                    _closed(run, first))

    from torch.profiler import ProfilerActivity, profile, schedule

    def stretch(n):
        if mode == "latency":
            return len(run.latency(0, scans=n)[0])
        return run.replay(0, lead, scans=n)[0]

    first = run.next
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        stretch(warm_scans)
        prof.step()
        with torch.profiler.record_function(devtrace.STRETCH):
            n = stretch(profile_scans)
        prof.step()
    rec["profile"] = devtrace.read(prof, n) if n else None
    phases["profile"] = phase_bounds(run, "profile", first)
    first = run.next
    rec["program"] = p = program.phase(
        run, mode, int(traffic["trace_program_scans"]), lead)
    phases["program"] = phase_bounds(
        run, "program", first, p and sum(
            bool(s.get("loop_tick") and s["loop_tick"]["closed"])
            for s in p["scans"]))
    return rec
