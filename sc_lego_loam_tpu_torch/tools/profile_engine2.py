"""Per-stage engine cost by differencing whole ``process_scan`` loops (the
counterpart of the JAX package's ``tools/profile_engine2.py``).

    python -m sc_lego_loam_tpu_torch.tools.profile_engine2 [--device cuda]
        (PROF_REAL=1: the real path's configuration and skewed drive)

Four engines over the bench's figure-8 (240 scans; ``synthetic_config()``
on the ordered drive, or ``runner.mulran_engine_config()`` on the skewed
one), each timed over the scans after 16 warm-up scans, one
``torch.cuda.synchronize()`` closing the window (the engines replay their
steps as CUDA graphs, the default on the card):

  A  mapping and loop closure off          -> perception ms/scan
  B  mapping every scan, no loop closure   -> A + mapping ms/tick
  C  mapping every scan, a loop tick every mapping tick -> B + loop ms/tick
  D  the bench's configuration (mapping every 0.3 s, a loop tick every
     3rd mapping tick)                     -> ms/scan and scans/s

The stage costs are the differences.  ``--device`` defaults to ``cuda``
and fails without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..config import synthetic_config
from ..pipeline import SlamEngine
from ..runner import mulran_engine_config
from . import bench

WARM = 16


def configs(base):
    """The four engine configurations, A to D."""
    a = base.replace(
        mapping=dataclasses.replace(base.mapping, process_interval=1e9),
        loop=dataclasses.replace(base.loop, enabled=False))
    b = base.replace(
        mapping=dataclasses.replace(base.mapping, process_interval=0.0),
        loop=dataclasses.replace(base.loop, enabled=False))
    c = base.replace(
        mapping=dataclasses.replace(base.mapping, process_interval=0.0),
        loop=dataclasses.replace(base.loop, check_every_ticks=1))
    return a, b, c, base


def ms_per_scan(cfg, scans, valids, device, warm=WARM):
    """Milliseconds a scan over the scans after ``warm``, the window closed
    by one synchronize."""
    engine = SlamEngine(cfg, device=device)
    for i in range(warm):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    bench.sync(device)
    t0 = time.perf_counter()
    for i in range(warm, len(scans)):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    bench.sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / (len(scans) - warm)
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return ms


def run(base, scans, valids, device, card, warm=WARM):
    """Prints the four rows and the stage costs; returns (a, b, c, d)."""
    out = []
    labels = ("A perception only", "B + mapping every scan",
              "C + loop every tick", "bench config (map/3, loop/9)")
    for label, cfg in zip(labels, configs(base)):
        ms = ms_per_scan(cfg, scans, valids, device, warm)
        out.append(ms)
        extra = ""
        if len(out) == 2:
            extra = f" (mapping ~{out[1] - out[0]:.3f} ms/tick)"
        elif len(out) == 3:
            extra = f" (loop ~{out[2] - out[1]:.3f} ms/tick)"
        elif len(out) == 4:
            extra = f" = {1e3 / ms:.0f} fps"
        print(f"{label:34s} {ms:8.3f} ms/scan{extra} [{card}]", flush=True)
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    card = bench.card_line(device)
    real = os.environ.get("PROF_REAL", "0") == "1"
    base = mulran_engine_config() if real else synthetic_config()
    kw = dict(trajectory="figure8", noise=0.01, seed=11, shuffle=False,
              radius=30.0, loops=1.05)
    if real:
        kw["skew"] = True
    scans, valids, _ = bench.get_sequence(base.lidar, bench.N_SCANS, **kw)
    print(f"config: {'real' if real else 'ordered'} [{card}]", flush=True)
    run(base, scans, valids, device, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
