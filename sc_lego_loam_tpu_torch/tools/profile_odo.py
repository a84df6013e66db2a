"""Feature counts per ring and odometry cost at four iteration settings
(the counterpart of the JAX package's ``tools/profile_odo.py``).

    python -m sc_lego_loam_tpu_torch.tools.profile_odo [--device cuda]

The JAX tool's docstring calls it an A/B of ring-blocked against flat
correspondence search, but its code sweeps iterations, and so does this
one: first the per-ring counts of the last scan's less-flat and less-sharp
features (does a ring overflow?), then ``odometry.step`` at
(max_iterations, research_every) = (12, 2), (12, 3), (8, 2) and (8, 4)
with the convergence deltas zeroed, timed as ``profile_iters`` times it
(device ms of graph replays with the copy-in apart, eager host ms,
launches of one call).  Inputs: ``profile_iters``' 8 scans.
``--device`` defaults to ``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import synthetic_config
from . import bench, profile_iters

GRID = [(12, 2), (12, 3), (8, 2), (8, 4)]


def ring_counts(cfg, fs):
    """(less-flat counts per ring, less-sharp counts per ring) of one
    feature set, numpy."""
    def per_ring(fc):
        ring = fc.ring.cpu().numpy()[fc.mask.cpu().numpy()]
        return np.bincount(ring, minlength=cfg.lidar.n_scan)
    return per_ring(fs.less_flat), per_ring(fs.less_sharp)


def run(cfg, scans, valids, device, card, grid=GRID,
        reps=profile_iters.REPS, profile=True):
    """Prints the ring counts and the grid's rows; returns (less-flat
    counts, less-sharp counts, rows)."""
    feats = profile_iters.features(cfg, scans, valids, device)
    lf, ls = ring_counts(cfg, feats[-1])
    print(f"less_flat per-ring counts: max={lf.max()} "
          f"p95={int(np.percentile(lf, 95))} total={lf.sum()} [{card}]",
          flush=True)
    print(f"less_sharp per-ring counts: max={ls.max()} total={ls.sum()} "
          f"[{card}]", flush=True)
    rows = profile_iters.odometry_grid(cfg, feats, device, grid, reps,
                                       profile)
    profile_iters.print_rows(rows, card)
    return lf, ls, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    card = bench.card_line(device)
    cfg = synthetic_config()
    scans, valids, _ = profile_iters.make_scans(cfg)
    run(cfg, scans, valids, device, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
