"""Quick regression diagnostic: ATE, loops and keyframes of the tiny
configuration's figure-8 (the counterpart of the JAX package's
``tools/diag_tiny.py``).

    python -m sc_lego_loam_tpu_torch.tools.diag_tiny [--device cuda]

``tiny_test_config()`` with the JAX tool's loop overrides (Scan Context
excludes the 10 latest keyframes; a loop tick every 2nd mapping tick;
radius search 4 m, 4 s apart) over an 80-scan figure-8 of radius 12 m
(1.05 laps, noise 0.01, seed 3).  The JAX tool runs on its CPU unless
``DIAG_TPU=1``; this one runs on the card unless ``--device cpu``, and
fails without a card.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import tiny_test_config
from ..pipeline import SlamEngine
from ..utils import evaluate, synthetic
from . import bench

N = 80
SEED = 3


def config(base=tiny_test_config):
    cfg = base()
    return cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=10),
        loop=dataclasses.replace(
            cfg.loop, enabled=True, check_every_ticks=2,
            rs_time_gap=4.0, rs_search_radius=4.0))


def make_scans(cfg, n=N, seed=SEED):
    return synthetic.make_sequence(
        cfg.lidar, n, trajectory="figure8", radius=12.0, loops=1.05,
        noise=0.01, seed=seed, shuffle=not cfg.lidar.ordered)


def run(cfg, scans, valids, gt, device, card):
    """Drive the engine, print and return (ATE m, loops closed,
    keyframes)."""
    engine = SlamEngine(cfg, device=device)
    for i in range(len(scans)):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    loops, kf = int(engine.loops_closed), int(engine.m.kf.count)
    print(f"ate={ate:.4f} loops={loops} kf={kf} [{card}]", flush=True)
    return ate, loops, kf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    cfg = config()
    scans, valids, gt = make_scans(cfg)
    run(cfg, scans, valids, gt, device, bench.card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
