"""Seed-tail loop diagnosis: replay the ordered figure-8 and print, at
every loop tick, what the detector and the verifier saw (the counterpart
of the JAX package's ``tools/diag_loops.py``).

    python -m sc_lego_loam_tpu_torch.tools.diag_loops [seed ...]
        [--device cuda]        (default seeds: 11 15; DIAG_CLOVER=1 for
                                the bench's cloverleaf)

``synthetic_config()`` over the bench's ordered figure-8 (240 scans,
radius 30 m, 1.05 laps; or the 520-scan cloverleaf).  After every
``process_scan`` that ran a loop tick, ``tick_record`` reads the engine's
state: the Scan Context candidate (``scan_context.detect``: index,
distance against ``sc.dist_threshold``, yaw), the radius-search candidate
(``loop.detect_radius``), and for each candidate the ICP
(``loop.keyframe_cloud`` at the candidate's or the current pose,
``loop.history_submap``, ``icp.align``, the SC yaw as its initial guess):
fitness against ``loop.fitness_threshold``, inlier ratio against
``loop.min_inlier_ratio``.  So a high-ATE seed can be told a retrieval
miss (no candidate), a verification reject (a candidate the gates refuse)
or geometry (accepted factors and the drift all the same).  Then ATE,
loops, keyframes and, per accepted factor, its translation error against
ground truth (TRUE under 2 m).

The engine's loop tick is a graph replay on the card, so the records are
read after ``process_scan`` returns, as the JAX tool reads them, never
inside the replay; they change nothing of the engine's state.
``--device`` defaults to ``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import loop
from ..config import synthetic_config
from ..models import scan_context
from ..ops import icp
from ..pipeline import SlamEngine
from ..utils import evaluate, se3
from . import bench

SEEDS = [11, 15]
FACTOR_TRUE_M = 2.0   # the JAX tool's TRUE / FALSE mark


def _icp(cfg, kf, cur, cand, place, T0=None):
    """The ICP of keyframe ``cur`` placed at ``place`` onto the history
    submap around ``cand``: {idx, fitness, inlier_ratio, accept}."""
    dev = kf.poses6.device
    src, srcm = loop.keyframe_cloud(cfg, kf, torch.tensor(cur, device=dev),
                                    place)
    dst, dstm = loop.history_submap(cfg, kf, torch.tensor(cand, device=dev))
    _, fit, inl = icp.align(cfg, src, srcm, dst, dstm, T0=T0)
    fit, inl = float(fit), float(inl)
    ok = fit < cfg.loop.fitness_threshold and \
        inl >= cfg.loop.min_inlier_ratio
    return dict(idx=cand, fitness=fit, inlier_ratio=inl, accept=ok)


def tick_record(cfg, engine):
    """What the loop tick saw on ``engine``'s state (read on the host):
    {kf, sc_idx, sc_dist, sc_yaw, rs_idx, sc, rs}, ``sc`` / ``rs`` the ICP
    of that candidate ({idx, fitness, inlier_ratio, accept}) or None (no
    candidate; ``rs`` also None when it is the SC candidate)."""
    m = engine.m
    kf = m.kf
    cur = max(int(kf.count) - 1, 0)
    sc_idx, sc_dist, sc_yaw = scan_context.detect(cfg, m.bank,
                                                  m.bank.desc[cur])
    rs_idx = loop.detect_radius(cfg, kf, torch.tensor(
        cur, device=kf.poses6.device))
    si, ri = int(sc_idx), int(rs_idx)
    rec = dict(kf=cur, sc_idx=si, sc_dist=float(sc_dist),
               sc_yaw=float(sc_yaw), rs_idx=ri, sc=None, rs=None)
    if si >= 0:
        place = se3.pose6_to_mat(kf.poses6[si])
        zero = torch.zeros_like(sc_yaw)
        Rz = se3.rt_to_mat(se3.euler_zyx_to_mat(-sc_yaw, zero, zero),
                           torch.zeros(3, device=zero.device))
        rec["sc"] = _icp(cfg, kf, cur, si, place,
                         T0=place @ Rz @ se3.mat_inv(place))
    if ri >= 0 and ri != si:
        rec["rs"] = _icp(cfg, kf, cur, ri, se3.pose6_to_mat(kf.poses6[cur]))
    return rec


def format_record(scan, rec, cfg) -> str:
    """The JAX tool's line for one loop tick."""
    head = f"scan {scan:4d} kf {rec['kf']:3d}:"
    if rec["sc"] is None and rec["rs_idx"] < 0:
        return (f"{head} no candidate (best SC dist {rec['sc_dist']:.3f} "
                f"vs thr {cfg.sc.dist_threshold})")
    parts = [head]
    if rec["sc"] is not None:
        s = rec["sc"]
        parts.append(f"SC->{s['idx']} dist={rec['sc_dist']:.3f} "
                     f"fit={s['fitness']:.3f} inl={s['inlier_ratio']:.3f} "
                     f"accept={s['accept']}")
    if rec["rs"] is not None:
        r = rec["rs"]
        parts.append(f"RS->{r['idx']} fit={r['fitness']:.3f} "
                     f"inl={r['inlier_ratio']:.3f} accept={r['accept']}")
    return " ".join(parts)


def factor_errors(engine, gt):
    """Per accepted factor (k, keyframe i, keyframe j, translation error
    against ground truth, m): ``evaluate.loop_precision_recall``'s test."""
    loops = engine.loops
    kf_times = engine.m.kf.times.cpu().numpy()
    li, lj = loops.i.cpu().numpy(), loops.j.cpu().numpy()
    lz = loops.z.cpu().numpy()
    gt = np.asarray(gt, np.float64)
    out = []
    for k in range(min(int(loops.count), li.shape[0])):
        a, b = int(li[k]), int(lj[k])
        sa = min(int(round(float(kf_times[a]) / 0.1)), len(gt) - 1)
        sb = min(int(round(float(kf_times[b]) / 0.1)), len(gt) - 1)
        z_gt = np.linalg.inv(gt[sa]) @ gt[sb]
        out.append((k, a, b, float(np.linalg.norm(lz[k][:3, 3]
                                                  - z_gt[:3, 3]))))
    return out


def replay(cfg, scans, valids, gt, device, label=""):
    """Drive a fresh engine over the scans, recording every loop tick;
    prints the records, the summary line and the factors.  Returns a dict:
    engine, records (each with its ``scan``), est (the trajectory), ate,
    factors (``factor_errors``)."""
    engine = SlamEngine(cfg, device=device)
    records = []
    ticks = 0
    for i in range(len(scans)):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
        if engine.loop_ticks == ticks:
            continue
        ticks = engine.loop_ticks
        rec = tick_record(cfg, engine)
        rec["scan"] = i
        records.append(rec)
        print(format_record(i, rec, cfg), flush=True)
    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    print(f"{label}: ate={ate:.3f} loops_closed="
          f"{int(engine.loops_closed)} kf={int(engine.m.kf.count)}",
          flush=True)
    factors = factor_errors(engine, gt)
    for k, a, b, err in factors:
        print(f"  factor {k:2d}: kf {a:3d}->{b:3d} gt-err={err:6.2f} m "
              f"{'TRUE' if err < FACTOR_TRUE_M else 'FALSE'}", flush=True)
    return dict(engine=engine, records=records, est=est, ate=ate,
                factors=factors)


def drive(cfg, seed, clover=False):
    """The bench's ordered figure-8 (or cloverleaf) at ``seed``."""
    if clover:
        return bench.get_sequence(
            cfg.lidar, bench.CLOVER_SCANS, trajectory="cloverleaf",
            noise=0.01, seed=seed, shuffle=False, radius=32.0, petals=4)
    return bench.get_sequence(
        cfg.lidar, bench.N_SCANS, trajectory="figure8", noise=0.01,
        seed=seed, shuffle=False, radius=30.0, loops=1.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="*", type=int, default=SEEDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = bench.require_device(args.device)
    card = bench.card_line(device)
    cfg = synthetic_config()
    clover = os.environ.get("DIAG_CLOVER", "0") == "1"
    for seed in args.seeds:
        scans, valids, gt = drive(cfg, seed, clover)
        print(f"\n===== seed {seed} ===== [{card}]", flush=True)
        replay(cfg, scans, valids, gt, device, label=f"seed {seed}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
