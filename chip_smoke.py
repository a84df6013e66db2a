#!/usr/bin/env python3
"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: torch/CUDA versions and the card's name and power limit;
2. build: compile the hand-written CUDA kNN (``csrc/knn.cu``) from the
   checkout and load it;
3. kernel vs plain version: the kernel and ``ops/knn.py`` on the same
   tensors on the card, at the main path's shapes (scan-to-map 5-NN, corner
   and surf) and at the ICP 1-NN shape, timed with CUDA events;
4. slice: ``SlamEngine(cfg, device="cuda")`` over the bench's motion-skewed
   OS1-64 figure-8 (``default_config()`` with loop closure off), with the
   kNN launch count, ATE against ground truth, scans/s, peak memory and
   the host syncs the timed window makes.

It fails (non-zero exit, no ``ok`` line) when there is no card or any
check fails.  The second-to-last line is the kernel summary, the last the
``ok`` object.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np
import torch

from sc_lego_loam_tpu.config import default_config
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch.ops import cuda_knn, knn as plain_knn
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import evaluate

KNN_SOURCE = "sc_lego_loam_tpu_torch/csrc/knn.cu"
KNN_REPLACES = "sc_lego_loam_tpu/ops/pallas_knn.py:146"

# (name, k, queries, targets, max_sq_dist): the scan-to-map 5-NN at the
# surf and corner submap pads of default_config(), and the ICP 1-NN.
SHAPES = [
    ("s2m_surf_k5", 5, 12288, 65536, 4.0),
    ("s2m_corner_k5", 5, 2048, 16384, 4.0),
    ("icp_k1", 1, 8192, 32768, 64.0),
]
TIE_REL = 1e-5        # slots this close to a neighbour's distance are ties
SQD_ATOL = 1e-4

N_SCANS = 24          # the first 24 scans of the bench's 240-scan path
WARMUP = 6
ATE_BAR = 1.0         # the verify recipe's PASS bar (m)


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
    live = int(qcnt.item())
    dead_ok = bool((idx[live:] == 0).all() and (sqd[live:] == max_sq).all())

    kern = lambda: cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt)  # noqa: E731
    plain = lambda: plain_knn.knn(q, t, mask, k, max_sq, qcnt)     # noqa: E731
    p1 = time_ms(plain, 3)
    k1 = time_ms(kern, 10)
    k2 = time_ms(kern, 10)
    p2 = time_ms(plain, 3)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"kernel {name}: k={k} Q={Q} T={T} valid_targets="
          f"{int(prep.cnt.item())} qcnt={live} max_sq_dist={max_sq} "
          f"compared_slots={int(compared.sum())}/{compared.size} "
          f"idx_mismatch={mismatch} max_abs_err={err:.3e} "
          f"(atol {SQD_ATOL}) rows>=qcnt_empty={dead_ok} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} [{card}]", flush=True)
    check(mismatch == 0, f"{name}: {mismatch} index mismatches")
    check(err <= SQD_ATOL, f"{name}: sqd error {err} > {SQD_ATOL}")
    check(dead_ok, f"{name}: rows past qcnt are not empty")
    return err, ms, plain_ms


def run_slice(card):
    cfg = default_config()
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=False))
    t0 = time.perf_counter()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_SCANS, trajectory="figure8", noise=0.01, seed=11,
        shuffle=False, skew=True, radius=30.0,
        loops=1.05 * (N_SCANS + 1) / 241)
    print(f"slice data: {N_SCANS} scans of {scans.shape[1]} points, host "
          f"generation {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    pts = torch.from_numpy(scans).cuda()
    msk = torch.from_numpy(valids).cuda()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlamEngine(cfg, device="cuda")
    cuda_knn.launches = 0
    for i in range(WARMUP):
        engine.process_scan(pts[i], msk[i], t=i * 0.1)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i in range(WARMUP, N_SCANS):
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()              # the window's one deliberate sync
    wall = time.perf_counter() - t0
    launches = cuda_knn.launches
    syncs = [w for w in rec if "synchronizing" in str(w.message)]
    peak = torch.cuda.max_memory_allocated()

    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    n_kf = int(engine.m.kf.count)
    m = cfg.mapping
    researches = 1 + sum(1 for it in range(1, m.max_iterations)
                         if it % m.research_every == 0)
    expected = 2 * researches * engine.map_ticks
    fps = (N_SCANS - WARMUP) / wall
    print(f"slice: scans={N_SCANS} warmup={WARMUP} scans_per_s={fps:.3f} "
          f"ms_per_scan={1e3 / fps:.3f} peak_mem_bytes={peak} "
          f"keyframes={n_kf} mapping_ticks={engine.map_ticks} "
          f"knn_launches={launches} (expected {expected}) "
          f"host_syncs_timed_window={len(syncs)} ate_m={ate:.4f} "
          f"[{card}]", flush=True)
    for where, n in Counter(f"{w.filename}:{w.lineno}"
                            for w in syncs).most_common():
        print(f"  host sync x{n} at {where}", flush=True)
    check(est.shape == (N_SCANS, 4, 4), f"trajectory shape {est.shape}")
    check(bool(np.isfinite(est).all()), "trajectory is not finite")
    check(launches > 0 and launches == expected,
          f"kNN launches {launches}, expected {expected}")
    check(ate < ATE_BAR, f"ATE {ate} >= {ATE_BAR} m")
    check(n_kf > 0, "no keyframe inserted")
    check("jax" not in sys.modules, "jax was imported")
    return launches


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a card",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    print(f"card: {card}", flush=True)

    info = cuda_knn.build()
    print(f"build: {info.path} in {info.seconds:.2f} s [{card}]", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    results = [kernel_vs_plain(name, k, Q, T, max_sq, seed, card)
               for seed, (name, k, Q, T, max_sq) in enumerate(SHAPES)]

    launches = run_slice(card)

    err_k5 = max(r[0] for r in results[:2])
    _, ms, plain_ms = results[0]
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "knn_topk_k5", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES, "launches": launches,
        "max_abs_err": err_k5, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
