"""Per-sub-stage times of ``perception_step``, ``mapping_step`` and
``loop_step`` on a real engine state (the counterpart of the JAX package's
``tools/profile_stages.py``): the table ``PERF.md``'s budget is built from.

    python -m sc_lego_loam_tpu_torch.tools.profile_stages [--device cuda]

The engine first runs 60 scans of the bench's figure-8 (``synthetic_config()``,
or ``runner.mulran_engine_config()`` and the skewed drive with
``PROF_REAL=1``), so that the banks' occupancy is the bench's; then each
sub-stage runs on that state, on scan 60, and prints:

- ``ms_synchronized``: host clock around one call that ends in
  ``torch.cuda.synchronize()``, mean over n calls;
- ``device_ms``: CUDA events around n calls back to back, per call (on a
  host-bound stage, the host's pace);
- ``host_ms``: host clock to launch one call, from the same n calls;
- ``launches`` and ``kernel_ms``: the device kernels one call runs and
  their summed device time (one ``torch.profiler`` session over one call of
  every sub-stage, opened only after every timing: after a first profiler
  session every later launch is slower);
- ``host_syncs``: the syncs of one call (``torch.cuda.set_sync_debug_mode``).

On the card more rows time replays of CUDA graphs (``graphs.StepGraph``,
what ``SlamEngine`` and ``BatchEngine`` run) captured on copies of the
engine's state, beside the eager sub-stages and whole steps: one
``perception_step`` and one ``mapping_step`` replay; a ``loop_step``
replay by outcome (its gates conditional nodes): with both detectors shut
(no candidate), and with the radius search opened to every keyframe
(``rs_time_gap`` 0, ``rs_search_radius`` 1000 m: the current keyframe's
own neighbourhood is a candidate) under a fitness gate nothing passes (a
verification, no re-solve) and under the configured gates (a re-solve);
each row names the outcome its warm-up had.  Then the three batched steps of a
``BatchEngine`` of 3 sequences, each the engine's state.

The submap occupancy prints last.  ``--device`` defaults to ``cuda`` and
fails without a card; on the CPU only ``ms_synchronized`` and ``host_ms``
are measured.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import os
import time
import warnings

import torch

from .. import frontend, graphs, mapping, odometry, pipeline
from ..config import synthetic_config
from ..models import scan_context
from ..ops import cuda_knn
from ..pipeline import SlamEngine
from ..runner import mulran_engine_config
from . import bench

PROF_SCANS = 60       # scans driven before the state is profiled
REPS = 20             # calls per timing of a sub-stage (whole steps: half)
PART_TAG = "profile_stages part "   # the profiler range of a sub-stage
GAP_S = 0.1           # idle host time before each part in the profile


def split_by_part(events, n_parts, is_kernel):
    """[(count, summed ms)] by part of the profiler ``events`` that
    ``is_kernel`` picks.  An event belongs to the part whose ``PART_TAG``
    range lies nearest its start (0 inside it).  Every part ends in a
    synchronize inside its range and the parts lie ``GAP_S`` apart, so a
    skew of the device's timestamps against the host's (a few ms seen on
    the card over a session of seconds) moves no kernel to another part.
    The ranges' own events count for none."""
    ranges = sorted((e.time_range.start, e.time_range.end,
                     int(e.name[len(PART_TAG):]))
                    for e in events if e.name.startswith(PART_TAG))
    starts = [r[0] for r in ranges]
    out = [[0, 0.0] for _ in range(n_parts)]
    for e in events:
        if not ranges or e.name.startswith(PART_TAG) or not is_kernel(e):
            continue
        t = e.time_range.start
        k = bisect.bisect_right(starts, t)
        near = ranges[max(0, k - 2):k + 2]
        part = out[min(near, key=lambda r: max(r[0] - t, t - r[1], 0))[2]]
        part[0] += 1
        part[1] += e.time_range.elapsed_us() / 1e3
    return [tuple(p) for p in out]


def measure(parts, device):
    """``parts``: (name, fn, n) triples.  Times every part first (n calls
    synchronized one by one, then n calls between CUDA events), then counts
    each one's host syncs, then profiles one call of each, all in one
    session.  Returns a dict per part: ``sync_ms``, ``device_ms``,
    ``host_ms``, ``launches``, ``kernel_ms``, ``syncs`` and ``sync_at``
    (where each was raised); all but the first and third None on the
    CPU."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rows = []
    for name, fn, n in parts:
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            sync()
        row = dict(name=name, n=n,
                   sync_ms=1e3 * (time.perf_counter() - t0) / n,
                   device_ms=None, launches=None, kernel_ms=None, syncs=None,
                   sync_at=None)
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        row["host_ms"] = 1e3 * (time.perf_counter() - t0) / n
        if cuda:
            ev1.record()
            ev1.synchronize()
            row["device_ms"] = ev0.elapsed_time(ev1) / n
        rows.append(row)
    if not cuda:
        return rows

    for row, (_, fn, _) in zip(rows, parts):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        row["sync_at"] = [f"{w.filename}:{w.lineno}" for w in rec
                          if "synchroniz" in str(w.message)]
        row["syncs"] = len(row["sync_at"])
        sync()

    # One session for every part: each session costs seconds of its own.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, (_, fn, _) in enumerate(parts):
            time.sleep(GAP_S)
            with record_function(f"{PART_TAG}{i}"):
                fn()
                sync()
    got = split_by_part(prof.events(), len(parts),
                        lambda e: e.device_type == DeviceType.CUDA)
    for row, (launches, kernel_ms) in zip(rows, got):
        row["launches"], row["kernel_ms"] = launches, kernel_ms
    return rows


def stage_parts(engine: SlamEngine, points, mask, t: float, reps=REPS):
    """The sub-stages of one scan's perception and mapping, and a loop tick,
    on ``engine``'s state and the scan (``points``, ``mask``) at time
    ``t``: (name, fn, n) triples for ``measure``.  Nothing the engine reads
    later changes: the in-place keyframe writes land in the bank's next
    slot, which ``count`` hides (a full bank rewrites its last slot with its
    own contents), and the trajectory rings written are a copy's."""
    cfg, dev = engine.config, engine.device
    p, m = engine.p, engine.m
    odo = p.odo
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    msk = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    t = torch.full((), t, dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)
    p_copy = pipeline._own(p, dev)

    fo = frontend.run(cfg, pts, msk)
    fo2 = pipeline._pre_deskew(cfg, fo, odo) if cfg.odom.deskew else fo
    fs, out_pts, out_mask = pipeline._extract(cfg, fo2.cloud, fo2.outlier)
    sub = mapping.build_submap(cfg, m.kf)
    c, cm, s, sm, o, om = mapping.downsample_scan(
        cfg, odo.corner_last.xyz, odo.corner_last.mask, odo.surf_last.xyz,
        odo.surf_last.mask, out_pts, out_mask)
    surf_q, surf_qm = torch.cat([s, o]), torch.cat([sm, om])
    yes = torch.ones((), dtype=torch.bool, device=dev)
    half = max(1, reps // 2)

    parts = [("frontend.run", lambda: frontend.run(cfg, pts, msk), reps)]
    if cfg.odom.deskew:
        parts.append(("pipeline._pre_deskew",
                      lambda: pipeline._pre_deskew(cfg, fo, odo), reps))
    parts += [
        ("pipeline._extract (features + outlier compact)",
         lambda: pipeline._extract(cfg, fo2.cloud, fo2.outlier), reps),
        ("odometry.step", lambda: odometry.step(cfg, odo, fs), reps),
        ("perception_step (whole)", lambda: pipeline.perception_step(
            cfg, p_copy, eye, pts, msk, t), half),
        ("mapping.build_submap (incl. decimate)",
         lambda: mapping.build_submap(cfg, m.kf), reps),
        ("mapping.downsample_scan", lambda: mapping.downsample_scan(
            cfg, odo.corner_last.xyz, odo.corner_last.mask,
            odo.surf_last.xyz, odo.surf_last.mask, out_pts, out_mask), reps),
        (f"mapping.scan_to_map ({cfg.mapping.max_iterations} it)",
         lambda: mapping.scan_to_map(cfg, m.pose, c, cm, surf_q, surf_qm,
                                     *sub), reps),
        ("scan_context.make_descriptor",
         lambda: scan_context.make_descriptor(pts, msk, cfg.sc), reps),
        ("mapping.insert_keyframe", lambda: mapping.insert_keyframe(
            cfg, m.kf, yes, m.pose, t, c, cm, s, sm, o, om), reps),
        ("mapping_step (whole)", lambda: pipeline.mapping_step(
            cfg, m, odo.corner_last.xyz, odo.corner_last.mask,
            odo.surf_last.xyz, odo.surf_last.mask, out_pts, out_mask,
            odo.pose, pts, msk, t, p.imu), half),
    ]
    if cfg.loop.enabled:
        parts.append(("loop_step", lambda: pipeline.loop_step(cfg, m), half))
    if dev.type == "cuda":
        parts += replay_parts(engine, pts, msk, t, reps)
    return parts, sub


def replay_parts(engine: SlamEngine, pts, msk, t, reps=REPS):
    """One ``perception_step`` replay and one ``mapping_step`` replay: the
    engine's two steps as ``graphs.StepGraph``s on a copy of its state
    (the keyframe banks copied once, on the card), warmed up and captured
    here.  Each replay advances the copy, never the engine."""
    cfg, dev = engine.config, engine.device
    backend = graphs.CudaCapture(dev)
    perception = graphs.StepGraph(
        lambda p, corr, x, k, tt: pipeline.perception_step(
            cfg, p, corr, x, k, tt), backend, "perception_step")
    mapping_graph = graphs.StepGraph(
        lambda m, *args: (pipeline.mapping_step(cfg, m, *args),), backend,
        "mapping_step")
    state = {"p": pipeline._own(engine.p, dev),
             "m": pipeline._own(engine.m, dev)}
    corr = state["m"].correction.clone()
    out = {}

    def perceive():
        state["p"], *rest = perception(state["p"], corr, pts, msk, t)
        out["args"] = rest

    def map_tick():
        p = state["p"]
        odom_pose, out_pts, out_mask, _ = out["args"]
        (state["m"],) = mapping_graph(
            state["m"], p.odo.corner_last.xyz, p.odo.corner_last.mask,
            p.odo.surf_last.xyz, p.odo.surf_last.mask, out_pts, out_mask,
            odom_pose, pts, msk, t, p.imu)

    for _ in range(2):              # warm-up, then capture (+ one replay)
        perceive()
        map_tick()
    half = max(1, reps // 2)
    parts = [("perception_step (CUDA graph replay)", perceive, reps),
             ("mapping_step (CUDA graph replay)", map_tick, half)]
    if cfg.loop.enabled:
        parts += loop_replay_parts(engine, backend, half)
    return parts + batch_replay_parts(engine, pts, msk, t, half)


def _small_copy(state, limit=4 << 20):
    """``state`` with its leaves under ``limit`` bytes copied and the banks
    shared (a loop tick only reads them)."""
    return graphs.unflatten(state, iter(
        x.clone() if x.numel() * x.element_size() < limit else x
        for x in graphs.flatten(state)))


def loop_replay_parts(engine: SlamEngine, backend, reps):
    """A ``loop_step`` graph replay by outcome (see the module docstring),
    each graph over its own copy of the engine's small state leaves."""
    cfg = engine.config
    opened = dataclasses.replace(cfg.loop, rs_time_gap=0.0,
                                 rs_search_radius=1e3)
    configs = [("both detectors shut", cfg.replace(
                    sc=dataclasses.replace(cfg.sc, dist_threshold=-1.0),
                    loop=dataclasses.replace(cfg.loop,
                                             rs_search_radius=0.0))),
               ("radius search opened, fitness gate shut",
                cfg.replace(loop=dataclasses.replace(
                    opened, fitness_threshold=-1.0))),
               ("radius search opened", cfg.replace(loop=opened))]
    parts = []
    for name, c in configs:
        g = graphs.StepGraph(lambda m, c=c: (pipeline.loop_step(c, m),),
                             backend, "loop_step")
        before = int(engine.m.loops_closed)
        k1 = cuda_knn.launches[1]
        (warm,) = g(_small_copy(engine.m))
        graphs.flush_counts()
        outcome = ("closed" if int(warm.loops_closed) > before else
                   "verified" if cuda_knn.launches[1] > k1 else
                   "no candidate")
        (state,) = g(_small_copy(engine.m))
        parts.append((f"loop_step {outcome}, {name} (CUDA graph replay)",
                      lambda g=g, state=state: g(state), reps))
    return parts


def batch_replay_parts(engine: SlamEngine, pts, msk, t, reps, S=3):
    """Replays of ``BatchEngine``'s three graphs (S sequences, each the
    engine's state; the banks copied S times, on the card) on the scan
    ``pts`` given to every sequence."""
    from ..parallel import batch as pbatch

    b = pbatch.BatchEngine(engine.config, n_seq=S, device=engine.device)
    b.s = b.s._replace(
        odo=pbatch._stack(engine.p.odo, S), map=pbatch._stack(engine.map, S),
        bank=pbatch._stack(engine.m.bank, S),
        loops=pbatch._stack(engine.m.loops, S),
        last_kf_odom=pbatch._stack(engine.m.last_kf_odom, S))
    P, M, T, I = b._stage(torch.stack([pts] * S), torch.stack([msk] * S),
                          float(t))
    out = {}

    def perceive():
        out["p"] = b._run(0, b._perceive, P, M, I)

    def map_tick():
        b._run(1, b._map_step, out["p"][0], out["p"][1], P, M, T, I)

    def loop_tick():
        b._run(2, b._loop_step, I)

    for _ in range(2):              # warm-up, then capture (+ one replay)
        perceive()
        map_tick()
        loop_tick()
    return [(f"batch perception, {S} sequences (CUDA graph replay)",
             perceive, reps),
            (f"batch mapping tick, {S} sequences (CUDA graph replay)",
             map_tick, reps),
            (f"batch loop tick, {S} sequences (CUDA graph replay)",
             loop_tick, reps)]


def _num(x, fmt):
    return "n/a" if x is None else format(x, fmt)


def profile_engine(engine: SlamEngine, points, mask, t: float, card: str,
                   reps=REPS):
    """Measure and print the sub-stage table on ``engine``'s state, then
    the submap occupancy.  Returns ``measure``'s rows."""
    parts, sub = stage_parts(engine, points, mask, t, reps)
    rows = measure(parts, engine.device)
    for r in rows:
        print(f"stage {r['name']:48s} ms_synchronized={r['sync_ms']:.3f} "
              f"device_ms={_num(r['device_ms'], '.3f')} "
              f"host_ms={r['host_ms']:.3f} "
              f"launches={_num(r['launches'], 'd')} "
              f"kernel_ms={_num(r['kernel_ms'], '.3f')} "
              f"host_syncs={_num(r['syncs'], 'd')} (n={r['n']}) [{card}]",
              flush=True)
        for at in sorted(set(r["sync_at"] or ())):
            print(f"  sync x{r['sync_at'].count(at)} at {at}", flush=True)
    _, sub_cm, _, sub_sm = sub
    print(f"submap occupancy: corner {int(sub_cm.sum())}/{sub_cm.shape[0]} "
          f"surf {int(sub_sm.sum())}/{sub_sm.shape[0]} keyframes "
          f"{int(engine.m.kf.count)} [{card}]", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    real = os.environ.get("PROF_REAL", "0") == "1"
    cfg = mulran_engine_config() if real else synthetic_config()
    kw = dict(trajectory="figure8", noise=0.01, seed=bench.SEED,
              shuffle=False, radius=30.0, loops=1.05)
    if real:
        kw["skew"] = True
    scans, valids, _ = bench.get_sequence(cfg.lidar, bench.N_SCANS, **kw)
    card = bench.card_line(device)
    print(f"config: {'real (skew + de-skew)' if real else 'ordered'}, "
          f"{PROF_SCANS} scans driven [{card}]", flush=True)
    engine = SlamEngine(cfg, device=device)
    for i in range(PROF_SCANS):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    profile_engine(engine, scans[PROF_SCANS], valids[PROF_SCANS],
                   PROF_SCANS * 0.1, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
