"""One ``SlamEngine`` and sequence 0 of a ``BatchEngine`` over identical
scans, on the card: where and why they part.

    python -m sc_lego_loam_tpu_torch.tools.batch_vs_single [--scans 240]

The drive is ``chip_smoke.py``'s batch drive (320-scan skewed figure-8
over 1.6 laps, seed 11); the single engine runs window 0 (scans 0..239),
the batch engine windows 0, 40, 80 as the batch path does, both at
``default_config()``.  The JAX ``BatchEngine``'s own rules differ from the
single engine's, and the script separates them out:

- the published pose uses this tick's correction in the batch and the
  last tick's in the single engine: the single engine's stream is also
  rebuilt with this tick's correction (``correction_i @ odom_i``);
- the descriptor goes in under ``inserted`` (under ``should`` in the single
  engine; the same unless the bank is full) and there is no
  ``kf_dropped``: neither acts below 16,384 keyframes.

It prints keyframes, loops, ATE of each stream (published, published with
this tick's correction, through the keyframe graph), where the mapped
poses first part by more than 1 mm and the largest differences, beside
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from ..config import default_config
from ..parallel import batch as pbatch
from ..pipeline import SlamEngine, graph_trajectory
from ..utils import evaluate, synthetic

STARTS = (0, 40, 80)
DRIVE_SCANS, LAPS = 320, 1.6


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _ate(est, gt):
    return evaluate.ate_rmse(est, gt[:len(est)])


def _max_pos(a, b):
    return float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=240)
    n = ap.parse_args(argv).scans
    card = _card()
    cfg = default_config()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, DRIVE_SCANS, trajectory="figure8", radius=30.0,
        loops=LAPS, noise=0.01, seed=11, shuffle=False, skew=True,
        workers=min(8, os.cpu_count() or 1))
    pts = torch.from_numpy(scans).cuda()
    msk = torch.from_numpy(valids).cuda()
    gt0 = gt[:n]

    # The single engine: mapped pose and correction after every scan.
    single = SlamEngine(cfg)
    s_pose, s_corr = [], []
    t0 = time.perf_counter()
    for i in range(n):
        single.process_scan(pts[i], msk[i], t=i * 0.1)
        s_pose.append(single.m.pose.clone())
        s_corr.append(single.m.correction.clone())
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    s_pose = torch.stack(s_pose).cpu().numpy()
    s_corr = torch.stack(s_corr).cpu().numpy()
    s_pub = single.trajectory_array(retro_correct=False)
    s_graph = single.trajectory_array()
    s_odom = single.p.odom_traj[:n].cpu().numpy()
    s_rule = s_corr @ s_odom             # with this tick's correction

    # The batch engine: sequence 0's odometry pose and mapped pose.
    eng = pbatch.BatchEngine(cfg, n_seq=len(STARTS))
    inner = eng._perception
    b_odom, b_pose = [], []

    def perception(*a):
        out = inner(*a)
        b_odom.append(out[1][0].clone())
        return out

    eng._perception = perception
    window = torch.tensor(STARTS, device="cuda")
    t0 = time.perf_counter()
    for i in range(n):
        eng.process_scans(pts[window + i], msk[window + i], t=i * 0.1)
        b_pose.append(eng.map.pose[0].clone())
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    b_pose = torch.stack(b_pose).cpu().numpy()
    b_pub = eng.trajectory_array(0)
    kf0 = type(eng.map.kf)(*(x[0] for x in eng.map.kf))
    b_graph = graph_trajectory(b_pub, torch.stack(b_odom).cpu().numpy(),
                               np.arange(n, dtype=np.float32) * 0.1, kf0,
                               int(kf0.count))
    d_map = np.abs(s_pose[:, :3, 3] - b_pose[:, :3, 3]).max(-1)
    part = np.flatnonzero(d_map > 1e-3)
    first = int(part[0]) if len(part) else -1
    print(f"single vs batch sequence 0, identical scans ({n}, window 0 of "
          f"the batch drive): keyframes {int(single.m.kf.count)} / "
          f"{int(kf0.count)}; loops_closed {int(single.loops_closed)} / "
          f"{int(eng.loops_closed[0])}; ATE published {_ate(s_pub, gt0):.4f}"
          f" / {_ate(b_pub, gt0):.4f}; single with this tick's correction "
          f"{_ate(s_rule, gt0):.4f}; through the keyframe graph "
          f"{_ate(s_graph, gt0):.4f} / {_ate(b_graph, gt0):.4f} m [{card}]",
          flush=True)
    print(f"  the single stream rebuilt with this tick's correction against "
          f"the batch's published one: max {_max_pos(s_rule, b_pub):.3e} m; "
          f"mapped poses first part by > 1 mm after scan {first} (max "
          f"{d_map.max():.3e} m); graph trajectories max "
          f"{_max_pos(s_graph, b_graph):.3e} m; drive s {s_wall:.1f} / "
          f"{b_wall:.1f} (the batch steps 3 sequences) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
