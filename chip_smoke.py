#!/usr/bin/env python3
"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py [--drive cloverleaf]

Phases, each printing its own lines:

1. device: torch/CUDA versions and the card's name and power limit;
2. data: the bench's headline drive (motion-skewed OS1-64 figure-8, 240
   scans) from the port's own generator, rays cast in worker processes;
3. build: compile the hand-written CUDA kNN (``csrc/knn.cu``) from the
   checkout and load it;
4. kernel vs plain version: the kernel and ``ops/knn.py`` on the same
   tensors on the card, at the main paths' shapes (scan-to-map 5-NN, corner
   and surf; ICP 1-NN), timed with CUDA events, beside the least time the
   card could take for the same work;
5. slice: ``SlamEngine(cfg, device="cuda")`` with loop closure off over the
   first scans of the drive;
6. loop path: ``SlamEngine(default_config(), device="cuda")``, loop closure
   on, over the whole drive: Scan Context retrieval, ICP through the kernel
   at k=1, pose-graph re-solve; kNN launches per k, accepted loop factors
   against ground truth, ATE, scans/s, peak memory, and the host syncs of
   loop ticks apart from the rest;
7. loop tick breakdown: the parts of one loop tick (retrieval, radius
   detection, history submap, keyframe cloud, ICP, one verification, the
   re-solve) on the loop path's end state, each with its synchronized
   time, its kernel launches and its host syncs.

``--drive cloverleaf`` swaps the figure-8 for the bench's loop precision /
recall drive (520 scans, four petals through one centre, three revisit
events): the same phases and checks over a path that accepts many factors.

It fails (non-zero exit, no ``ok`` line) when there is no card or any
check fails.  The second-to-last line is the kernel summary, the last the
``ok`` object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np
import torch

from sc_lego_loam_tpu_torch import loop, pipeline, posegraph
from sc_lego_loam_tpu_torch.config import default_config
from sc_lego_loam_tpu_torch.models import scan_context
from sc_lego_loam_tpu_torch.ops import cuda_knn, icp, knn as plain_knn
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import evaluate, se3, synthetic

KNN_SOURCE = "sc_lego_loam_tpu_torch/csrc/knn.cu"
KNN_REPLACES = "sc_lego_loam_tpu/ops/pallas_knn.py:146"

# (name, k, queries, targets, max_sq_dist): the scan-to-map 5-NN at the
# surf and corner submap pads of default_config(), and the ICP 1-NN at its
# query and history pads.
SHAPES = [
    ("s2m_surf_k5", 5, 12288, 65536, 4.0),
    ("s2m_corner_k5", 5, 2048, 16384, 4.0),
    ("icp_k1", 1, 8192, 32768, 64.0),
]
TIE_REL = 1e-5        # slots this close to a neighbour's distance are ties
SQD_ATOL = 1e-4

# Published peaks of one H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# One pair distance: 3 subtractions, a multiply, two FMAs (2 each) and the
# compare against the current k-th best.
FLOPS_PER_PAIR = 9

# name -> (scans, (trajectory, its arguments)): the bench's headline drive
# (bench.py _real_sequence) and its loop precision / recall drive
# (bench.py block_clover_real); both noise 0.01, seed 11, motion-skewed,
# capture order.
DRIVES = {
    "figure8": (240, (synthetic.figure8_trajectory,
                      dict(radius=30.0, loops=1.05))),
    "cloverleaf": (520, (synthetic.cloverleaf_trajectory,
                         dict(radius=32.0, petals=4))),
}
LOOP_WARMUP = 6
SLICE_SCANS = 12      # loop-off slice: the drive's first scans
SLICE_WARMUP = 4
ATE_BAR = 1.0         # the verify recipe's PASS bar (m)
FACTOR_TOL_M = 1.0    # a loop factor is true within this of ground truth
SYNC_FILES = ("ops/solver.py", "torch/cuda/__init__.py")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(name, k, Q, T, max_sq, seed, card):
    """Kernel against the plain version on one shape, ~50 % valid targets
    and 90 % live queries.  Indices must agree in every slot whose distance
    is not tied (within TIE_REL) with a neighbouring slot's."""
    rng = np.random.default_rng(seed)
    box = np.array([20.0, 20.0, 2.0], np.float32)
    q = torch.from_numpy(rng.uniform(-box, box, (Q, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-box, box, (T, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random(T) < 0.5)
    q, t, mask = q.cuda(), t.cuda(), mask.cuda()
    qcnt = torch.full((1,), int(0.9 * Q), dtype=torch.int32, device="cuda")

    prep = cuda_knn.prepare_targets(t, mask)
    idx, sqd = cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt)
    ref_idx, ref_sqd = plain_knn.knn(q, t, mask, k + 1, max_sq, qcnt)
    torch.cuda.synchronize()
    idx, sqd = idx.cpu().numpy(), sqd.cpu().numpy()
    ref_idx, ref_sqd = ref_idx.cpu().numpy(), ref_sqd.cpu().numpy()

    err = float(np.abs(sqd - ref_sqd[:, :k]).max())
    d = ref_sqd.astype(np.float64)
    gap = np.maximum(np.abs(d), 1e-12) * TIE_REL
    found = d < max_sq                    # an empty slot is never a tie
    tied_next = (np.abs(d[:, 1:] - d[:, :-1]) <= gap[:, :-1]) \
        & found[:, :-1]                                          # (Q,k)
    tied = tied_next.copy()
    tied[:, 1:] |= tied_next[:, :-1]
    edge = d[:, :k]                       # found just inside the range edge
    tied |= (np.abs(edge - max_sq) <= gap[:, :k]) & (edge != max_sq)
    compared = ~tied
    mismatch = int((idx[compared] != ref_idx[:, :k][compared]).sum())
    live, tcnt = int(qcnt.item()), int(prep.cnt.item())
    dead_ok = bool((idx[live:] == 0).all() and (sqd[live:] == max_sq).all())

    # The least time the card could take for this call: the live pairs'
    # arithmetic at the fp32 peak, or every input read once (queries,
    # compacted targets, the slot -> index map, the two counts) and every
    # output written once (int64 index and fp32 distance per slot).
    pairs = live * tcnt
    moved = Q * 12 + T * 12 + T * 8 + 8 + Q * k * 12
    ops_ms = 1e3 * pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * moved / PEAK_BYTES_PER_S
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))

    kern = lambda: cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt)  # noqa: E731
    plain = lambda: plain_knn.knn(q, t, mask, k, max_sq, qcnt)     # noqa: E731
    p1 = time_ms(plain, 3)
    k1 = time_ms(kern, 10)
    k2 = time_ms(kern, 10)
    p2 = time_ms(plain, 3)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"kernel {name}: k={k} Q={Q} T={T} valid_targets={tcnt} "
          f"qcnt={live} max_sq_dist={max_sq} "
          f"compared_slots={int(compared.sum())}/{compared.size} "
          f"idx_mismatch={mismatch} max_abs_err={err:.3e} "
          f"(atol {SQD_ATOL}) rows>=qcnt_empty={dead_ok} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} live_pairs={pairs} "
          f"bytes_moved={moved} bound_ms={bound_ms:.5f} "
          f"(operations {ops_ms:.5f}, bytes {bytes_ms:.5f}) "
          f"bound_share={bound_ms / ms:.4f} library_ms=none "
          f"(no single PyTorch call computes a masked, range-gated exact "
          f"top-k of pair distances) [{card}]", flush=True)
    check(mismatch == 0, f"{name}: {mismatch} index mismatches")
    check(err <= SQD_ATOL, f"{name}: sqd error {err} > {SQD_ATOL}")
    check(dead_ok, f"{name}: rows past qcnt are not empty")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def small_linalg_times(card):
    """The ICP's rigid fit: a batch-1 3x3 ``torch.linalg.svd`` on the card,
    and the whole weighted fit at the ICP's query pad."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cov = torch.randn(3, 3, device="cuda", generator=g)
    src = torch.randn(8192, 3, device="cuda", generator=g)
    w = torch.ones(8192, device="cuda")
    svd_ms = time_ms(lambda: torch.linalg.svd(cov), 50)
    fit_ms = time_ms(lambda: se3.best_fit_transform(src, src + 0.1, w), 50)
    print(f"linalg: svd_3x3_ms={svd_ms:.4f} best_fit_transform_8192_ms="
          f"{fit_ms:.4f} (15 fits per ICP) [{card}]", flush=True)


def make_drive(cfg, drive, card):
    """One of ``DRIVES``, rays cast in worker processes."""
    n_scans, (trajectory, shape) = DRIVES[drive]
    kw = dict(trajectory=trajectory.__name__.removesuffix("_trajectory"),
              noise=0.01, seed=11, shuffle=False, skew=True, **shape)
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    scans, valids, gt = synthetic.make_sequence(cfg.lidar, n_scans,
                                                workers=workers, **kw)
    took = time.perf_counter() - t0
    # The first scan once more, serially: the fan-out changed no bit.
    poses = trajectory(n_scans + 1, **shape)
    pts0, valid0 = synthetic.raycast_skewed(
        synthetic.default_world(seed=11), poses[0], poses[1], cfg.lidar,
        noise=0.01, rng=np.random.default_rng(12))
    check(np.array_equal(pts0, scans[0]) and np.array_equal(valid0, valids[0]),
          "scan 0 from the worker processes differs from the serial one")
    print(f"data: {drive}, {n_scans} scans of {scans.shape[1]} points, host "
          f"generation {took:.2f} s in {workers} processes, scan 0 equals "
          f"the serial ray cast [{card}]", flush=True)
    return scans, valids, gt


def sync_warnings(rec):
    return [w for w in rec if "synchroniz" in str(w.message)]


def where(w) -> str:
    return f"{w.filename}:{w.lineno}"


def print_syncs(label, syncs):
    for at, n in Counter(where(w) for w in syncs).most_common():
        print(f"  {label} host sync x{n} at {at}", flush=True)


def expected_k5(cfg, map_ticks: int) -> int:
    m = cfg.mapping
    researches = 1 + sum(1 for it in range(1, m.max_iterations)
                         if it % m.research_every == 0)
    return 2 * researches * map_ticks


def run_slice(pts, msk, gt, card):
    """Loop closure off over the drive's first scans."""
    cfg = default_config()
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlamEngine(cfg, device="cuda")
    cuda_knn.reset_launches()
    for i in range(SLICE_WARMUP):
        engine.process_scan(pts[i], msk[i], t=i * 0.1)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i in range(SLICE_WARMUP, SLICE_SCANS):
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()              # the window's one deliberate sync
    wall = time.perf_counter() - t0
    launches = dict(cuda_knn.launches)
    syncs = sync_warnings(rec)
    peak = torch.cuda.max_memory_allocated()

    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    n_kf = int(engine.m.kf.count)
    expected = expected_k5(cfg, engine.map_ticks)
    fps = (SLICE_SCANS - SLICE_WARMUP) / wall
    print(f"slice (loop closure off): scans={SLICE_SCANS} "
          f"warmup={SLICE_WARMUP} scans_per_s={fps:.3f} "
          f"ms_per_scan={1e3 / fps:.3f} peak_mem_bytes={peak} "
          f"keyframes={n_kf} mapping_ticks={engine.map_ticks} "
          f"knn_launches_k5={launches[5]} (expected {expected}) "
          f"knn_launches_k1={launches[1]} "
          f"host_syncs_timed_window={len(syncs)} ate_m={ate:.4f} "
          f"[{card}]", flush=True)
    print_syncs("slice", syncs)
    check(est.shape == (SLICE_SCANS, 4, 4), f"trajectory shape {est.shape}")
    check(bool(np.isfinite(est).all()), "trajectory is not finite")
    check(launches[5] > 0 and launches[5] == expected,
          f"slice: k=5 launches {launches[5]}, expected {expected}")
    check(launches[1] == 0, f"slice: k=1 launches {launches[1]} with loops off")
    check(engine.loop_ticks == 0, "slice: a loop tick ran with loops off")
    check(ate < ATE_BAR, f"slice: ATE {ate} >= {ATE_BAR} m")
    check(n_kf > 0, "slice: no keyframe inserted")
    return launches


def run_loop_path(pts, msk, gt, card):
    """The main path: ``default_config()``, loop closure on, the whole
    drive."""
    n_scans = len(gt)
    cfg = default_config()
    check(cfg.loop.enabled and not cfg.imu.enabled, "default_config changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlamEngine(cfg, device="cuda")
    cuda_knn.reset_launches()

    # Watch every loop tick from outside: which recorded warnings fall
    # inside it, CUDA events around it, the host clock, and the (device)
    # closure counter it returns, read after the run.
    rec: list = []
    ticks = []
    inner = pipeline.loop_step

    def watched_loop_step(config, mst):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        n0, k1 = len(rec), cuda_knn.launches[1]
        ev0.record()
        h0 = time.perf_counter()
        out = inner(config, mst)
        host_ms = 1e3 * (time.perf_counter() - h0)
        ev1.record()
        ticks.append(dict(w0=n0, w1=len(rec), ev0=ev0, ev1=ev1,
                          host_ms=host_ms, closed_after=out.loops_closed,
                          k1=cuda_knn.launches[1] - k1))
        return out

    pipeline.loop_step = watched_loop_step
    try:
        for i in range(LOOP_WARMUP):
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            rec = caught
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            for i in range(LOOP_WARMUP, n_scans):
                engine.process_scan(pts[i], msk[i], t=i * 0.1)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()          # the window's one final sync
        wall = time.perf_counter() - t0
    finally:
        pipeline.loop_step = inner
    launches = dict(cuda_knn.launches)
    peak = torch.cuda.max_memory_allocated()

    # Syncs: those inside a loop tick, and the rest.
    all_syncs = sync_warnings(rec)
    in_tick = set()
    for tk in ticks:
        in_tick.update(id(w) for w in rec[tk["w0"]:tk["w1"]])
    loop_syncs = [w for w in all_syncs if id(w) in in_tick]
    other_syncs = [w for w in all_syncs if id(w) not in in_tick]

    closed_before = 0
    for tk in ticks:
        after = int(tk["closed_after"])
        tk["closed"] = after > closed_before
        closed_before = after
        tk["ms"] = tk["ev0"].elapsed_time(tk["ev1"])
        tk["syncs"] = len(sync_warnings(rec[tk["w0"]:tk["w1"]]))

    def mean(xs):
        return sum(xs) / len(xs) if xs else float("nan")

    closed = [tk for tk in ticks if tk["closed"]]
    verified = [tk for tk in ticks if tk["k1"] > 0 and not tk["closed"]]
    idle = [tk for tk in ticks if tk["k1"] == 0]

    est = engine.trajectory_array()
    raw = engine.trajectory_array(retro_correct=False)
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    ate_raw = evaluate.ate_rmse(raw, gt[:len(raw)])
    pr = evaluate.loop_precision_recall(engine, gt, cfg, tol_m=FACTOR_TOL_M)
    n_kf = int(engine.m.kf.count)
    loops_closed = int(engine.loops_closed)
    timed = n_scans - LOOP_WARMUP
    fps = timed / wall
    expected5 = expected_k5(cfg, engine.map_ticks)
    k1_cap = 2 * engine.loop_ticks * (cfg.loop.icp_max_iterations + 1)

    print(f"loop path (default_config, loop closure on): scans={n_scans} "
          f"warmup={LOOP_WARMUP} scans_per_s={fps:.3f} "
          f"ms_per_scan={1e3 / fps:.3f} peak_mem_bytes={peak} "
          f"keyframes={n_kf} mapping_ticks={engine.map_ticks} "
          f"loop_ticks={engine.loop_ticks} "
          f"knn_launches_k5={launches[5]} (expected {expected5}) "
          f"knn_launches_k1={launches[1]} (at most {k1_cap}) "
          f"loops_closed={loops_closed} [{card}]", flush=True)
    print(f"loop factors: accepted={pr['accepted']} "
          f"true={pr['true_factors']} precision={pr['precision']} "
          f"recall={pr['recall']} revisit_events={pr['revisit_events']} "
          f"(gate {FACTOR_TOL_M} m) ate_m={ate:.4f} "
          f"ate_as_published_m={ate_raw:.4f} [{card}]", flush=True)
    for label, group in (("closed", closed), ("verified, not closed", verified),
                         ("no candidate", idle)):
        print(f"loop ticks {label}: n={len(group)} "
              f"mean_ms_cuda_events={mean([t['ms'] for t in group]):.3f} "
              f"mean_ms_host={mean([t['host_ms'] for t in group]):.3f} "
              f"mean_host_syncs={mean([t['syncs'] for t in group]):.2f} "
              f"mean_k1_launches={mean([t['k1'] for t in group]):.2f} "
              f"[{card}]", flush=True)
    print(f"host syncs in the {timed} timed scans: loop_ticks="
          f"{len(loop_syncs)} elsewhere={len(other_syncs)} [{card}]",
          flush=True)
    print_syncs("loop tick", loop_syncs)
    print_syncs("elsewhere", other_syncs)

    check(est.shape == (n_scans, 4, 4), f"trajectory shape {est.shape}")
    check(bool(np.isfinite(est).all()) and bool(np.isfinite(raw).all()),
          "trajectory is not finite")
    check(loops_closed >= 1, "loop path: no loop closed")
    check(len(closed) == loops_closed, "closed ticks and loops_closed differ")
    check(0 < launches[1] <= k1_cap,
          f"loop path: k=1 launches {launches[1]} not in (0, {k1_cap}]")
    check(launches[5] == expected5,
          f"loop path: k=5 launches {launches[5]}, expected {expected5}")
    check(pr["accepted"] >= 1 and pr["precision"] == 1.0,
          f"loop path: accepted factors not all true: {pr}")
    check(ate < ATE_BAR, f"loop path: ATE {ate} >= {ATE_BAR} m")
    # perception_step and mapping_step gained no sync: only the eigh of
    # solver.degeneracy_projector (one per odometry step and per mapping
    # tick) and the one inside torch/cuda, as before loop closure.
    stray = [w for w in other_syncs if not where(w).rsplit(":", 1)[0]
             .endswith(SYNC_FILES)]
    check(not stray, "a new sync outside the loop ticks: "
          + ", ".join(sorted({where(w) for w in stray})))
    check(len(other_syncs) <= timed + engine.map_ticks + 1,
          f"{len(other_syncs)} syncs outside loop ticks")
    return launches, engine


def loop_tick_breakdown(engine, card):
    """Where a loop tick's time goes, on the loop path's end state and for
    its first accepted factor (newer keyframe i against older j, the Scan
    Context route: query cloud placed at j's pose).  Per part: host time
    of a call that ends in a synchronize (mean of 3), the kernels it
    launches and their summed device time (``torch.profiler``, one call),
    and the host syncs it makes (sync debug mode, one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, m = engine.config, engine.m
    kf = m.kf
    cur, cand = m.loops.i[0].long(), m.loops.j[0].long()
    desc = m.bank.desc[cur.reshape(1)][0]
    place = se3.pose6_to_mat(kf.poses6[cand.reshape(1)][0])
    yaw = torch.zeros((), device=cur.device)
    src, src_mask = loop.keyframe_cloud(cfg, kf, cur, place)
    dst, dst_mask = loop.history_submap(cfg, kf, cand)
    parts = [
        ("retrieval (scan_context.detect, 16384-descriptor bank)",
         lambda: scan_context.detect(cfg, m.bank, desc)),
        ("radius detection (loop.detect_radius)",
         lambda: loop.detect_radius(cfg, kf, cur)),
        ("history submap (51 keyframes -> 32768 points)",
         lambda: loop.history_submap(cfg, kf, cand)),
        ("keyframe cloud (8192 points)",
         lambda: loop.keyframe_cloud(cfg, kf, cur, place)),
        ("ICP (icp.align, 15 iterations + fitness pass)",
         lambda: icp.align(cfg, src, src_mask, dst, dst_mask)),
        ("one verification (loop.verify: clouds + ICP + gates)",
         lambda: loop.verify(cfg, kf, cur, cand, place, yaw_init=yaw)),
        ("factor insert (posegraph.add_loop, 256-slot bank)",
         lambda: posegraph.add_loop(m.loops, cur, cand, place, kf.poses6)),
        ("re-solve (posegraph.solve, 16384 nodes, 256 factor slots)",
         lambda: posegraph.solve(cfg, kf.poses6, kf.count, kf.odom_z,
                                 m.loops)),
    ]
    for name, fn in parts:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / 3
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            fn()
            torch.cuda.set_sync_debug_mode("default")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        n_kernels = sum(e.count for e in on_card)
        dev_ms = sum(getattr(e, "self_device_time_total", 0) or 0
                     for e in on_card) / 1e3
        print(f"loop tick part: {name}: ms_synchronized={host_ms:.3f} "
              f"kernel_launches={n_kernels} device_ms={dev_ms:.3f} "
              f"host_syncs={len(sync_warnings(rec))} [{card}]", flush=True)
        check(n_kernels > 0, f"the profiler saw no kernel in: {name}")


def check_no_jax():
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "sc_lego_loam_tpu")
                 or m.startswith(("jax.", "sc_lego_loam_tpu.")))
    check(not bad, f"imported: {bad}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--drive", choices=sorted(DRIVES), default="figure8")
    drive = parser.parse_args().drive
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    print(f"card: {card}", flush=True)

    scans, valids, gt = make_drive(default_config(), drive, card)

    info = cuda_knn.build()
    print(f"build: {info.path} in {info.seconds:.2f} s [{card}]", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    results = [kernel_vs_plain(name, k, Q, T, max_sq, seed, card)
               for seed, (name, k, Q, T, max_sq) in enumerate(SHAPES)]
    small_linalg_times(card)

    pts = torch.from_numpy(scans).cuda()
    msk = torch.from_numpy(valids).cuda()
    slice_launches = run_slice(pts, msk, gt, card)
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s before the loop "
          f"path", flush=True)
    loop_launches, engine = run_loop_path(pts, msk, gt, card)
    loop_tick_breakdown(engine, card)
    check_no_jax()
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)

    surf, corner, icp = results
    common = dict(route="cuda", source=KNN_SOURCE, replaces=KNN_REPLACES)
    k5 = dict(name="knn_topk_k5", **common,
              launches=slice_launches[5] + loop_launches[5], **surf)
    k5["max_abs_err"] = max(surf["max_abs_err"], corner["max_abs_err"])
    k1 = dict(name="knn_topk_k1", **common, launches=loop_launches[1], **icp)
    check(k5["launches"] > 0 and k1["launches"] > 0,
          "a kernel of the path was never launched")
    print(f"card: {card}")
    print(json.dumps({"kernels": [k5, k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
