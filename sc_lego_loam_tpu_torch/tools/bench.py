"""Benchmark of the port: full-pipeline frames/s on one card, loops included
(the counterpart of the JAX package's ``bench.py``, with its blocks, its
configurations, its knobs and its JSON line).

    python -m sc_lego_loam_tpu_torch.tools.bench [--device cuda]

Six blocks, each in a process of its own, all running the complete engine
(frontend -> features -> odometry -> mapping -> Scan Context -> loop
closure -> pose graph) on synthetic OS1-64 worlds with analytic ground
truth:

1. ``ordered``: instantaneous beam-ordered scans (``synthetic_config()``:
   reshape projection, no de-skew), and the SEED SWEEP, the same figure-8 at
   ``BENCH_SWEEP`` seeds: the run-to-run ATE band;
2. ``clover``: loop precision / recall on a 4-petal cloverleaf whose centre
   is revisited 3 times (ordered);
3. ``real`` (the headline): motion-skewed scans in capture order
   (``runner.mulran_engine_config()``: scatter projection, carried-twist
   de-skew), lidar only;
4. ``real_imu``: the same scans with the IMU on and a 100 Hz stream
   synthesized from ground truth;
5. ``clover_real``: loop precision / recall on the skewed cloverleaf;
6. ``latency``: per-scan latency percentiles on the real path, with a
   ``torch.cuda.synchronize()`` after every scan.

Baseline: the reference's design target of 10 Hz real time
(``BASELINE.md``).  Scans are generated by host ray casting (in worker
processes) and cached in ``BENCH_CACHE_DIR``; generation never touches a
timed window.  One process per block, so that a failed block names itself
and no block inherits another's allocator state.  The knobs are
``bench.py``'s: ``BENCH_SCANS``, ``BENCH_WARMUP``, ``BENCH_SEED``,
``BENCH_SWEEP``, ``BENCH_CLOVER_SCANS``, ``BENCH_REAL``, ``BENCH_CLOVER``,
``BENCH_CACHE_DIR``, and ``BENCH_BLOCK`` to run one block.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"};
``extra`` adds to ``bench.py``'s keys ``device`` (the card's name and power
limit), ``knn_launches`` (the CUDA kNN's calls per block, k=5 and k=1)
and ``launches_per_scan`` (what the host puts on the stream a scan on the
real path, from a profiled run of its first scans after the ``real``
block's timed run, in its process).  The engines replay their per-scan steps as CUDA graphs, the
``SlamEngine`` default on the card.  ``--device`` defaults to ``cuda`` and
fails without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import ImuConfig, synthetic_config
from ..ops import cuda_knn
from ..pipeline import SlamEngine
from ..runner import mulran_engine_config
from ..utils import evaluate, synthetic

N_SCANS = int(os.environ.get("BENCH_SCANS", "240"))
# Warmup must cover every first-call path: mapping ticks, keyframe
# insertion, and the first loop-closure check (at check_every mapping ticks).
WARMUP = int(os.environ.get("BENCH_WARMUP", "16"))
SEED = int(os.environ.get("BENCH_SEED", "11"))
SWEEP_SEEDS = [int(s) for s in
               os.environ.get("BENCH_SWEEP", "11,12,13,14,15").split(",")
               if s]
CLOVER_SCANS = int(os.environ.get("BENCH_CLOVER_SCANS", "520"))
RUN_REAL = os.environ.get("BENCH_REAL", "1") == "1"
RUN_CLOVER = os.environ.get("BENCH_CLOVER", "1") == "1"
# Not the JAX bench's directory: the two benches never read each other's
# files.
CACHE_DIR = os.environ.get(
    "BENCH_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "scloam_torch_bench_cache"))
BASELINE_FPS = 10.0   # reference real-time rate (BASELINE.md)

_FRAG = "BENCH_FRAGMENT "


def require_device(device: str) -> torch.device:
    """The device a tool runs on: the card unless the caller asks for the
    CPU; no fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device; pass "
                           "--device cpu to run the plain versions")
    return dev


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's name for a CPU run."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def sync(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def get_sequence(lidar, n, **kw):
    """Disk-cached synthetic sequence, rays cast in worker processes."""
    key = hashlib.md5(repr((lidar, n, sorted(kw.items()))).encode()
                      ).hexdigest()[:16]
    path = os.path.join(CACHE_DIR, f"seq_{key}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["scans"], z["valids"], z["gt"]
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    scans, valids, gt = synthetic.make_sequence(lidar, n, workers=workers,
                                                **kw)
    print(f"data: {n} scans of {kw.get('trajectory')} "
          f"(skew={bool(kw.get('skew'))}, seed {kw.get('seed')}) cast in "
          f"{time.perf_counter() - t0:.2f} s in {workers} processes",
          file=sys.stderr, flush=True)
    os.makedirs(CACHE_DIR, exist_ok=True)
    # np.savez appends ".npz" unless the name already ends with it.
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez(tmp, scans=scans, valids=valids, gt=gt)
    os.replace(tmp, path)
    return scans, valids, gt


def make_imu(gt, seed):
    """The bench's IMU stream: 100 Hz, synthesized from the scan-end
    ground-truth poses (``utils/synthetic.make_imu_samples``)."""
    return synthetic.make_imu_samples(gt, t0=0.1, period=0.1, rate_hz=100,
                                      seed=seed)


def run_engine(cfg, scans, valids, warmup, imu=None, latency=None,
               device="cuda"):
    """Feed all scans; returns (engine, scans/s over the post-warm-up
    window, which ends with a ``torch.cuda.synchronize()``).

    ``imu``: optional (times, rpy, acc, gyro) stream; the samples up to
    each scan's END time are pushed before that scan, in one batch.
    ``latency``: optional list; when given, every scan ends in a
    synchronize and its wall milliseconds are appended: scans/s from such a
    run measures latency, not throughput."""
    engine = SlamEngine(cfg, device=device)
    engine.trace.on()           # its host spans: block_ordered prints them
    n = len(scans)
    cursor = 0

    def feed(i):
        nonlocal cursor
        if imu is not None:
            times, rpy, acc, gyro = imu
            end = int(np.searchsorted(times, (i + 1) * 0.1 + 1e-9,
                                      side="right"))
            if end > cursor:    # one batched push per scan
                engine.push_imu_batch(times[cursor:end], rpy[cursor:end],
                                      acc[cursor:end], gyro[cursor:end])
                cursor = end
        return engine.process_scan(scans[i], valids[i], t=i * 0.1)

    for i in range(warmup):
        feed(i)
    sync(engine.device)
    t0 = time.perf_counter()
    for i in range(warmup, n):
        t1 = time.perf_counter()
        feed(i)
        if latency is not None:
            sync(engine.device)
            latency.append((time.perf_counter() - t1) * 1e3)
    # The engine launches without waiting; the clock waits for the card to
    # finish the last scan.
    sync(engine.device)
    return engine, (n - warmup) / (time.perf_counter() - t0)


def ates(engine, gt, warmup):
    """(ATE over the run, steady ATE over the post-warm-up scans), m: the
    first scans carry a bootstrap transient (cold-start odometry at the
    sequences' ~7 m/s) that dominates the full-run RMSE."""
    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    ate_steady = evaluate.ate_rmse(est[warmup:], gt[warmup:len(est)])
    return round(float(ate), 4), round(float(ate_steady), 4)


def loop_pr(engine, gt, cfg):
    """``evaluate.loop_precision_recall`` with precision and recall rounded
    to 3 places, as ``bench.py`` reports them."""
    pr = evaluate.loop_precision_recall(engine, gt, cfg)
    for k in ("precision", "recall"):
        if pr[k] is not None:
            pr[k] = round(pr[k], 3)
    return pr


def block_ordered(device, cfg=None, n_scans=N_SCANS, warmup=WARMUP,
                  seeds=SWEEP_SEEDS):
    """Ordered path + seed sweep; scans/s and the first seed's counts come
    from the first seed, later seeds contribute ATE and loops."""
    cfg = cfg or synthetic_config()
    seeds = seeds or [SEED]
    sweep = {"seeds": seeds, "ate": [], "ate_steady": [],
             "loops_closed": []}
    ordered = None
    for seed in seeds:
        scans, valids, gt = get_sequence(
            cfg.lidar, n_scans, trajectory="figure8", noise=0.01,
            seed=seed, shuffle=False, radius=30.0, loops=1.05)
        engine, fps = run_engine(cfg, scans, valids, warmup, device=device)
        ate, ate_steady = ates(engine, gt, warmup)
        sweep["ate"].append(ate)
        sweep["ate_steady"].append(ate_steady)
        sweep["loops_closed"].append(int(engine.loops_closed))
        if seed == seeds[0]:
            ordered = {
                "fps": round(fps, 2), "ate_rmse_m": ate,
                "ate_steady_m": ate_steady,
                "scans": n_scans - warmup,
                "keyframes": int(engine.m.kf.count),
                "loops_closed": int(engine.loops_closed),
                "revisit_events": evaluate.revisit_mask(
                    gt, cfg.loop.rs_search_radius)[1],
            }
            print(engine.trace.table(skip_first=2), file=sys.stderr)
    for k in ("ate", "ate_steady"):
        v = sweep[k]
        sweep[f"{k}_mean"] = round(sum(v) / len(v), 4)
        sweep[f"{k}_min"] = min(v)
        sweep[f"{k}_max"] = max(v)
    return {"platform": torch.device(device).type, "ordered": ordered,
            "seed_sweep": sweep}


def block_clover(device, cfg=None, n_scans=CLOVER_SCANS, warmup=WARMUP):
    """Loop precision / recall on the >= 3-revisit cloverleaf (ordered)."""
    cfg = cfg or synthetic_config()
    scans, valids, gt = get_sequence(
        cfg.lidar, n_scans, trajectory="cloverleaf", noise=0.01,
        seed=SEED, shuffle=False, radius=32.0, petals=4)
    engine, fps = run_engine(cfg, scans, valids, warmup, device=device)
    ate, _ = ates(engine, gt, warmup)
    pr = loop_pr(engine, gt, cfg)
    pr.update({"fps": round(fps, 2), "ate_rmse_m": ate,
               "trajectory": "cloverleaf", "scans": n_scans})
    return {"loop_pr": pr}


def real_sequence(cfg, n_scans):
    """The headline drive: skewed figure-8 in CAPTURE order (column-major),
    so the scatter projection runs, while the first and last points still
    anchor the intra-scan sweep as every real sensor stream does
    (findStartEndAngle, iP.cpp:199-209)."""
    return get_sequence(
        cfg.lidar, n_scans, trajectory="figure8", noise=0.01,
        seed=SEED, shuffle=False, skew=True, radius=30.0, loops=1.05)


# Runtime calls that put work on a stream, by name prefix (torch.profiler's
# CUDA runtime / driver events).
LAUNCH_CALLS = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel"),
                "graph": ("cudaGraphLaunch", "cuGraphLaunch"),
                "copy": ("cudaMemcpyAsync", "cuMemcpyAsync", "cudaMemsetAsync",
                         "cuMemsetAsync")}
LAUNCH_SCANS = 30     # profiled scans after the warm-up


def launches_per_scan(cfg, scans, valids, warmup, n=LAUNCH_SCANS,
                      device="cuda"):
    """What the host puts on the stream a scan: a fresh engine over the
    first ``warmup + n`` scans, ``torch.profiler`` over the last ``n``
    (opened after every timed run: a profiler session slows later
    launches).  Returns per scan: host calls by kind (kernel launches,
    graph launches, copies and fills), their sum, and the device kernels
    that ran; None on the CPU or for no scan."""
    if torch.device(device).type != "cuda" or n < 1:
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = SlamEngine(cfg, device=device)
    for i in range(warmup):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(warmup, warmup + n):
            engine.process_scan(scans[i], valids[i], t=i * 0.1)
        sync(device)
    host = dict.fromkeys(LAUNCH_CALLS, 0)
    kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += 1
            continue
        for kind, names in LAUNCH_CALLS.items():
            if e.name.startswith(names):
                host[kind] += 1
    out = {f"host_{k}": round(v / n, 2) for k, v in host.items()}
    out["host_launches"] = round(sum(host.values()) / n, 2)
    out["device_kernels"] = round(kernels / n, 2)
    out["scans"] = n
    return out


def block_real(device, cfg=None, n_scans=N_SCANS, warmup=WARMUP):
    """HEADLINE: the lidar-only real path (MulRan carries no IMU):
    scatter projection + carried-twist pre-de-skew + the rigid solver."""
    cfg = cfg or mulran_engine_config()
    scans, valids, gt = real_sequence(cfg, n_scans)
    engine, fps = run_engine(cfg, scans, valids, warmup, device=device)
    ate, ate_steady = ates(engine, gt, warmup)
    return {"real": {
        "fps": round(fps, 2), "ate_rmse_m": ate,
        "ate_steady_m": ate_steady, "scans": n_scans - warmup,
        "keyframes": int(engine.m.kf.count),
        "loops_closed": int(engine.loops_closed),
        "imu": False,
    }}


def block_real_imu(device, cfg=None, n_scans=N_SCANS, warmup=WARMUP):
    """The IMU in the loop on the identical skewed scans: the reference's
    operating mode (fA.cpp:491-619), with MEMS-grade noise."""
    cfg = cfg or mulran_engine_config()
    scans, valids, gt = real_sequence(cfg, n_scans)
    engine, fps = run_engine(cfg.replace(imu=ImuConfig(enabled=True)),
                             scans, valids, warmup,
                             imu=make_imu(gt, seed=SEED), device=device)
    ate, ate_steady = ates(engine, gt, warmup)
    # bench.py's keys hold no factor check; the log does.
    print(f"real_imu factors: {loop_pr(engine, gt, cfg)}", file=sys.stderr)
    return {"real_imu": {
        "fps": round(fps, 2), "ate_rmse_m": ate,
        "ate_steady_m": ate_steady,
        "loops_closed": int(engine.loops_closed),
    }}


def block_clover_real(device, cfg=None, n_scans=CLOVER_SCANS,
                      warmup=WARMUP):
    """Loop precision / recall ON THE REAL PATH (skewed cloverleaf,
    lidar only), where drift is largest and false factors likeliest."""
    cfg = cfg or mulran_engine_config()
    scans, valids, gt = get_sequence(
        cfg.lidar, n_scans, trajectory="cloverleaf", noise=0.01,
        seed=SEED, shuffle=False, skew=True, radius=32.0, petals=4)
    engine, fps = run_engine(cfg, scans, valids, warmup, device=device)
    ate, _ = ates(engine, gt, warmup)
    pr = loop_pr(engine, gt, cfg)
    pr.update({"fps": round(fps, 2), "ate_rmse_m": ate,
               "trajectory": "cloverleaf-skewed"})
    return {"loop_pr_real": pr}


def latency_ms(cfg, scans, valids, warmup, device="cuda"):
    """Per-scan latency percentiles (ms) over the scans after ``warmup``,
    each ending in a synchronize, loop ticks included; None for no timed
    scan."""
    lat = []
    run_engine(cfg, scans, valids, warmup, latency=lat, device=device)
    if not lat:
        return None
    a = np.asarray(lat)
    return {
        "p50": round(float(np.percentile(a, 50)), 2),
        "p95": round(float(np.percentile(a, 95)), 2),
        "p99": round(float(np.percentile(a, 99)), 2),
        "max": round(float(a.max()), 2),
        "scans": len(lat),
    }


def block_latency(device, cfg=None, n_scans=N_SCANS, warmup=WARMUP):
    """Per-scan LATENCY on the real path (the "real-time 10 Hz" framing
    needs p99), over the first warm-up + 160 scans."""
    cfg = cfg or mulran_engine_config()
    scans, valids, _ = real_sequence(cfg, n_scans)
    n_lat = min(n_scans, warmup + 160)
    lat = latency_ms(cfg, scans[:n_lat], valids[:n_lat], warmup, device)
    return {"latency_ms": lat} if lat else {}


BLOCKS = {
    "ordered": block_ordered,
    "clover": block_clover,
    "real": block_real,
    "real_imu": block_real_imu,
    "clover_real": block_clover_real,
    "latency": block_latency,
}


def block_names():
    """The blocks a whole run measures, in ``bench.py``'s order."""
    names = ["ordered"]
    if RUN_CLOVER:
        names.append("clover")
    if RUN_REAL:
        names += ["real", "real_imu"]
        if RUN_CLOVER:
            names.append("clover_real")
        names.append("latency")
    return names


def run_block(name, device):
    """One block in a process of its own; returns its fragment."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, BENCH_BLOCK=name, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", __spec__.name,
                        "--device", device],
                       env=env, capture_output=True, text=True)
    frag = None
    for line in r.stdout.splitlines():
        if line.startswith(_FRAG):
            frag = json.loads(line[len(_FRAG):])
    if frag is None:
        sys.stderr.write(r.stdout[-2000:])
        sys.stderr.write(r.stderr[-4000:])
        raise RuntimeError(
            f"bench block '{name}' failed (exit {r.returncode})")
    tail = [ln for ln in r.stderr.splitlines() if ln and "Warning" not in ln]
    data = [ln for ln in tail[:-8] if ln.startswith("data: ")]
    print("\n".join(data + tail[-8:]), file=sys.stderr)
    print(f"bench block {name}: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return frag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = str(require_device(ap.parse_args(argv).device))

    block = os.environ.get("BENCH_BLOCK", "")
    if block:
        cuda_knn.reset_launches()
        frag = BLOCKS[block](device)
        frag["knn_launches"] = {block: {f"k{k}": n for k, n in
                                        sorted(cuda_knn.launches.items())}}
        if block == "real":     # after the block's timing, in its process
            cfg = mulran_engine_config()
            scans, valids, _ = real_sequence(cfg, N_SCANS)
            frag["launches_per_scan"] = launches_per_scan(
                cfg, scans, valids, WARMUP,
                max(0, min(LAUNCH_SCANS, N_SCANS - WARMUP)), device)
        print(_FRAG + json.dumps(frag), flush=True)
        return 0

    extra = {"device": card_line(device), "knn_launches": {}}
    for name in block_names():
        frag = run_block(name, device)
        extra["knn_launches"].update(frag.pop("knn_launches"))
        extra.update(frag)

    headline = extra["real"]["fps"] if RUN_REAL else extra["ordered"]["fps"]
    print(json.dumps({
        "metric": "frames_per_sec_full_pipeline_real_path" if RUN_REAL
                  else "frames_per_sec_full_pipeline",
        "value": round(headline, 3),
        "unit": "frames/s",
        "vs_baseline": round(headline / BASELINE_FPS, 3),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
