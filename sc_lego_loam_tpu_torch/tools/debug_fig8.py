"""Figure-8 divergence diagnosis: per-frame odometry twist error against
ground truth (the counterpart of the JAX package's
``tools/debug_fig8.py``).

    python -m sc_lego_loam_tpu_torch.tools.debug_fig8 [--device cuda]

``tiny_test_config()``'s 16 x 128 sensor over a 60-scan figure-8 (radius
30 m, 1.05 laps, noise 0.01, seed 7), scan by scan through
``frontend.run`` -> ``features.extract`` -> ``odometry.step``; per frame
the ground-truth twist (rotation, translation), the estimate's error
(rotation deg, translation m) and the sharp / flat counts.  The JAX tool
forces its CPU; this one runs on the card unless ``--device cpu``, and
fails without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import frontend, odometry
from ..config import tiny_test_config
from ..ops import features as features_op
from ..utils import se3, synthetic
from . import bench

N = 60
SEED = 7


def make_scans(cfg, n=N, seed=SEED):
    return synthetic.make_sequence(
        cfg.lidar, n, trajectory="figure8", noise=0.01, seed=seed,
        shuffle=not cfg.lidar.ordered, radius=30.0, loops=1.05)


def twist_errors(cfg, scans, valids, gt, device):
    """One row per frame after the first: frame, gt twist (6,), estimated
    twist (6,), their difference, sharp and flat counts (numpy)."""
    state = odometry.init_state(cfg, device)
    rows = []
    for i in range(len(scans)):
        fo = frontend.run(cfg, torch.as_tensor(scans[i], device=device),
                          torch.as_tensor(valids[i], device=device))
        fs = features_op.extract(fo.cloud, cfg.feat, cfg.cap)
        state, _, xi = odometry.step(cfg, state, fs)
        if i == 0:
            continue
        T_gt = np.linalg.inv(gt[i - 1]) @ gt[i]
        xi_gt = se3.se3_log(torch.as_tensor(T_gt, dtype=torch.float32)
                            ).numpy()
        xi = xi.cpu().numpy()
        rows.append(dict(frame=i, xi_gt=xi_gt, xi=xi, err=xi - xi_gt,
                         sharp=int(fs.sharp.mask.sum()),
                         flat=int(fs.flat.mask.sum())))
    return rows


def format_row(r) -> str:
    g, e = r["xi_gt"], r["err"]
    return (f"{r['frame']:3d} gt_rot={np.degrees(np.linalg.norm(g[:3])):5.2f}"
            f"deg gt_t=({g[3]:6.3f},{g[4]:6.3f},{g[5]:6.3f}) "
            f"err_rot=({np.degrees(e[0]):6.3f},{np.degrees(e[1]):6.3f},"
            f"{np.degrees(e[2]):6.3f})deg "
            f"err_t=({e[3]:6.3f},{e[4]:6.3f},{e[5]:6.3f}) "
            f"sharp={r['sharp']} flat={r['flat']}")


def run(cfg, scans, valids, gt, device, card):
    rows = twist_errors(cfg, scans, valids, gt, device)
    for r in rows:
        print(f"{format_row(r)} [{card}]", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    cfg = tiny_test_config()
    scans, valids, gt = make_scans(cfg)
    run(cfg, scans, valids, gt, device, bench.card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
