"""How often a loop tick without a candidate stalls on the card, and a
``torch.profiler`` trace (host and device) of the slowest one.

    python -m sc_lego_loam_tpu_torch.tools.loop_tick_stall [--runs 3] \
        [--out DIR]

Three runs of the loop path (``SlamEngine(default_config())`` over the
bench's 240-scan skewed figure-8, as ``chip_smoke.py`` drives it) for each
of ``--modes`` (``graphed``: the engine's default, every loop tick a
replay of its graph after the first two, the gates conditional nodes;
``eager``: ``eager=True``, the gates host reads), each run in a process of
its own.  Every loop tick is timed by the host clock and by CUDA events; a
tick that launched no k=1 kNN (the host count, and the conditional
bodies' device counter, read after the run) had no candidate.  Such a
tick stalls when its host time exceeds 10x the median of its run's
no-candidate ticks and 50 ms.  The last run of each mode profiles every
no-candidate tick (CPU and CUDA activities; a profiler session slows the
launches after it, so the first runs go without) and writes the slowest
tick's chrome trace and its top operations to ``--out`` (a fresh temporary
directory unless given).  Times print beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import graphs
from ..config import default_config
from ..ops import cuda_knn
from ..pipeline import SlamEngine
from ..utils import synthetic

STALL_RATIO, STALL_MS = 10.0, 50.0
K1_SLOT = graphs.SLOTS.index(("knn", 1))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _k1():
    """k=1 kNN calls so far: the host count and a device copy of the
    conditional bodies' counter."""
    return (cuda_knn.launches[1],
            graphs.device_counter("cuda")[K1_SLOT].clone())


def run_once(data: str, out: str, run: int, profile: bool, mode: str):
    """One run of the loop path; writes ``<mode>_run<run>.json``."""
    scans = torch.from_numpy(np.load(os.path.join(data, "scans.npy"))).cuda()
    valids = torch.from_numpy(np.load(os.path.join(data, "valids.npy"))).cuda()
    engine = SlamEngine(default_config(), eager=mode == "eager")
    inner = engine.loop_tick
    ticks, traces = [], []

    def watched():
        k1 = _k1()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        prof = None
        if profile and ticks:    # the first tick is warm-up
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        ev0.record()
        h0 = time.perf_counter()
        inner()
        host_ms = 1e3 * (time.perf_counter() - h0)
        ev1.record()
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        ticks.append(dict(scan=len(ticks), host_ms=host_ms, ev=(ev0, ev1),
                          k1=(k1, _k1())))
        if prof is not None:
            traces.append((host_ms, len(ticks) - 1, prof))

    engine.loop_tick = watched
    t0 = time.perf_counter()
    for i in range(scans.shape[0]):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for tk in ticks:
        ev0, ev1 = tk.pop("ev")
        tk["ms"] = ev0.elapsed_time(ev1)
        (h0, d0), (h1, d1) = tk.pop("k1")
        tk["idle"] = h1 - h0 + int(d1) - int(d0) == 0
    traces = sorted((t for t in traces if ticks[t[1]]["idle"]),
                    key=lambda x: -x[0])[:1]
    res = dict(run=run, mode=mode, profiled=profile, wall_s=wall,
               scans=int(scans.shape[0]), ticks=ticks)
    if traces:
        host_ms, i, prof = traces[0]
        path = os.path.join(out, f"{mode}_run{run}_tick{i}.json")
        prof.export_chrome_trace(path)
        ka = prof.key_averages()
        try:
            top_dev = ka.table(sort_by="device_time_total", row_limit=8)
        except (KeyError, AttributeError, ValueError):
            top_dev = ka.table(sort_by="cuda_time_total", row_limit=8)
        res["slowest_idle"] = dict(
            tick=i, host_ms=host_ms, trace=path,
            top_cpu=ka.table(sort_by="cpu_time_total", row_limit=12),
            top_cuda=top_dev)
    with open(os.path.join(out, f"{mode}_run{run}.json"), "w") as f:
        json.dump(res, f, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--modes", default="graphed,eager")
    ap.add_argument("--out")
    ap.add_argument("--child", type=int)
    ap.add_argument("--data")
    args = ap.parse_args(argv)
    args.out = args.out or tempfile.mkdtemp(prefix="loop_tick_stall_")
    os.makedirs(args.out, exist_ok=True)
    if args.child is not None:
        run_once(args.data, args.out, args.child,
                 profile=args.child == args.runs - 1, mode=args.modes)
        return 0
    card = _card()
    cfg = default_config()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, 240, trajectory="figure8", radius=30.0, loops=1.05,
        noise=0.01, seed=11, shuffle=False, skew=True,
        workers=min(8, os.cpu_count() or 1))
    data = tempfile.mkdtemp(prefix="stall_")
    np.save(os.path.join(data, "scans.npy"), scans)
    np.save(os.path.join(data, "valids.npy"), valids)
    for mode, r in ((m, r) for m in args.modes.split(",")
                    for r in range(args.runs)):
        subprocess.run([sys.executable, "-m",
                        "sc_lego_loam_tpu_torch.tools.loop_tick_stall",
                        "--child", str(r), "--runs", str(args.runs),
                        "--modes", mode, "--data", data, "--out", args.out],
                       check=True)
        with open(os.path.join(args.out, f"{mode}_run{r}.json")) as f:
            res = json.load(f)
        idle = [t for t in res["ticks"] if t["idle"]][1:]
        busy = [t for t in res["ticks"] if not t["idle"]]
        med = float(np.median([t["host_ms"] for t in idle])) if idle else 0.0
        stalls = [t for t in idle if t["host_ms"] > max(STALL_RATIO * med,
                                                        STALL_MS)]
        print(f"{mode} run {r} (profiled: {res['profiled']}): "
              f"{res['scans']} scans "
              f"in {res['wall_s']:.1f} s; no-candidate ticks {len(idle)} "
              f"(after the first): median host ms {med:.2f}, max "
              f"{max([t['host_ms'] for t in idle], default=0):.2f}, CUDA-event "
              f"median {np.median([t['ms'] for t in idle]) if idle else 0:.2f};"
              f" stalled {len(stalls)} "
              f"({[round(t['host_ms'], 1) for t in stalls]}); ticks with a "
              f"verification {len(busy)} [{card}]", flush=True)
        if "slowest_idle" in res:
            s = res["slowest_idle"]
            print(f"  slowest profiled no-candidate tick: #{s['tick']} "
                  f"{s['host_ms']:.2f} host ms, trace {s['trace']}\n"
                  f"{s['top_cpu']}\n{s['top_cuda']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
