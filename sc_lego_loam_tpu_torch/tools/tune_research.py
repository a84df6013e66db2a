"""Research cadence A/B on the ordered bench path: scans/s and ATE over
seeds (the counterpart of the JAX package's ``tools/tune_research.py``).

    python -m sc_lego_loam_tpu_torch.tools.tune_research [variant ...]
        [--device cuda]

Variants: ``base`` (``synthetic_config()``), ``map_re4`` (scan-to-map
re-searches every 4th iteration), ``odo_re3`` (odometry every 3rd),
``both_re``, and ``exact``.  For each, the bench's ordered figure-8
(``BENCH_SCANS`` scans, default 240; radius 30 m, 1.05 laps) at seeds 11,
12, 13 through ``tools.bench.run_engine`` (16 warm-up scans; the engine's
CUDA graphs) prints the range of scans/s and of ATE, the mean ATE and the
loops closed per seed.  A setting must clear the seed band to count.

``exact`` is, in the JAX package, the exact XLA top-k in place of its
Pallas kNN.  The port's kNN (``csrc/knn.cu``) is exact already, so
``exact`` runs ``base``'s configuration and its row says so.  Without
variants the tool runs the first four.  ``--device`` defaults to ``cuda``
and fails without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..config import synthetic_config
from . import bench

SEEDS = [11, 12, 13]
N = int(os.environ.get("BENCH_SCANS", "240"))
WARM = 16
VARIANTS = ("base", "map_re4", "odo_re3", "both_re", "exact")


def variant_cfg(name, base=synthetic_config):
    """The configuration of a variant over ``base()``."""
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r}: one of {VARIANTS}")
    cfg = base()
    if name in ("map_re4", "both_re"):
        cfg = cfg.replace(mapping=dataclasses.replace(
            cfg.mapping, research_every=4))
    if name in ("odo_re3", "both_re"):
        cfg = cfg.replace(odom=dataclasses.replace(
            cfg.odom, research_every=3))
    return cfg


def ordered_drive(lidar, seed, n_scans=N):
    """The bench's ordered figure-8 at ``seed``."""
    return bench.get_sequence(lidar, n_scans, trajectory="figure8",
                              noise=0.01, seed=seed, shuffle=False,
                              radius=30.0, loops=1.05)


def run_variant(name, seeds, device, card, n_scans=N, warm=WARM,
                base=synthetic_config, sequence=None):
    """One variant over ``seeds``: prints its row, returns a dict of the
    per-seed scans/s, ATE and loops closed.  ``sequence(seed)`` gives a
    seed's (scans, valids, gt) (default: ``ordered_drive``)."""
    cfg = variant_cfg(name, base)
    fpss, ates, loops = [], [], []
    for seed in seeds:
        scans, valids, gt = (sequence(seed) if sequence is not None else
                             ordered_drive(cfg.lidar, seed, n_scans))
        engine, fps = bench.run_engine(cfg, scans, valids, warm,
                                       device=str(device))
        ate, _ = bench.ates(engine, gt, warm)
        fpss.append(fps)
        ates.append(ate)
        loops.append(int(engine.loops_closed))
        del engine
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    note = (" (the port's kNN is exact: base's configuration)"
            if name == "exact" else "")
    print(f"{name:10s} fps={min(fpss):6.1f}-{max(fpss):6.1f} "
          f"ate={min(ates):.3f}-{max(ates):.3f} "
          f"mean={sum(ates) / len(ates):.3f} loops={loops}{note} [{card}]",
          flush=True)
    return dict(name=name, fps=fpss, ate=ates, loops=loops)


def run(names, seeds, device, card, n_scans=N, warm=WARM,
        base=synthetic_config, sequence=None):
    return [run_variant(name, seeds, device, card, n_scans, warm, base,
                        sequence) for name in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*",
                    default=["base", "map_re4", "odo_re3", "both_re"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = bench.require_device(args.device)
    run(args.variants, SEEDS, device, bench.card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
