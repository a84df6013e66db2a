"""Per-stage device latency of 14 stages of perception, mapping and loop
closure (the counterpart of the JAX package's
``tools/profile_latency.py``).

    python -m sc_lego_loam_tpu_torch.tools.profile_latency [--device cuda]

The JAX tool's harness (every stage a ``lax.scan`` over its inputs inside
one jit, the carry chained) answers a trait of the TPU runtime: it
overlaps independent dispatches and its ``block_until_ready`` does not
wait for execution.  Neither holds on the card, where the kernels of one
stream run in order and a CUDA event records when the stream reaches it,
so that harness is not copied: each stage runs back to back on distinct
inputs (the 16 scans in turn; the state stages on a warm engine's state)
under ``tools/profile_stages.measure``, which prints per call
``device_ms`` (CUDA events around n calls), ``ms_synchronized`` (a
synchronize after each call), ``host_ms`` (launching), and, from one
profiler session after every timing, ``launches`` and ``kernel_ms``.

Inputs: 16 scans of ``synthetic_config()``'s figure-8 (radius 30 m, 0.15
laps, seed 11, beam order); the engine is warmed on the same 16 scans.
The stages, in the JAX tool's order: projection, proj+ground+
segmentation, frontend.run, frontend+features, perception (frontend+
feat+odometry), odometry.step, mapping.scan_to_map,
mapping.downsample_scan, mapping.build_submap, sc.make_descriptor,
sc.detect (K bank), loop.history_submap, loop.verify (ICP),
posegraph.solve.  ``--device`` defaults to ``cuda`` and fails without a
card; on the CPU only the host columns are measured.
"""

from __future__ import annotations

import argparse
import itertools

import torch

from .. import frontend, loop, mapping, odometry, pipeline, posegraph
from ..config import synthetic_config
from ..models import scan_context
from ..ops import ground, projection, segmentation
from ..utils import se3
from . import bench, profile_iters, profile_stages

N = 16
STAGES = ("projection", "proj+ground+segmentation", "frontend.run",
          "frontend+features", "perception (frontend+feat+odometry)",
          "odometry.step", "mapping.scan_to_map", "mapping.downsample_scan",
          "mapping.build_submap", "sc.make_descriptor", "sc.detect (K bank)",
          "loop.history_submap", "loop.verify (ICP)", "posegraph.solve")


def make_scans(cfg, n=N):
    return bench.get_sequence(cfg.lidar, n, trajectory="figure8",
                              radius=30.0, loops=0.15, noise=0.01, seed=11,
                              shuffle=False)


def stage_parts(cfg, scans, valids, engine, reps=N):
    """(name, fn, n) of the 14 stages for ``profile_stages.measure``: a
    per-scan stage takes the next scan at each call; odometry and
    perception carry their state from call to call."""
    dev = engine.device
    pts = [torch.as_tensor(p, device=dev) for p in scans]
    msk = [torch.as_tensor(m, device=dev) for m in valids]
    nxt = itertools.cycle(range(len(pts)))
    lid, seg = cfg.lidar, cfg.seg
    project = projection.project_ordered if lid.ordered else \
        projection.project

    def scan():
        i = next(nxt)
        return pts[i], msk[i]

    def proj():
        return project(*scan(), lid)

    def proj_seg():
        img = project(*scan(), lid)
        g = ground.ground_mask(img, lid, seg)
        return segmentation.segment(img, g, lid, seg)

    def front():
        return frontend.run(cfg, *scan())

    def front_feat():
        fo = frontend.run(cfg, *scan())
        return pipeline._extract(cfg, fo.cloud, fo.outlier)

    state = {"p": odometry.init_state(cfg, dev),
             "o": odometry.init_state(cfg, dev)}

    def perceive():
        state["p"] = pipeline._odo_perception(cfg, *scan(), state["p"])[0]

    feats = profile_iters.features(cfg, scans, valids, dev)
    fit = itertools.cycle(feats)

    def odo():
        state["o"] = odometry.step(cfg, state["o"], next(fit))[0]

    T0, c, cm, surf_q, surf_qm, *sub = profile_iters.map_inputs(cfg, engine)
    m, p = engine.m, engine.p
    kf = m.kf
    zeros = torch.zeros((cfg.cap.outlier_pad, 3), device=dev)
    none = torch.zeros((cfg.cap.outlier_pad,), dtype=torch.bool, device=dev)
    cur = torch.clamp(kf.count - 1, min=0)
    first = torch.zeros((), dtype=torch.int64, device=dev)
    place = se3.pose6_to_mat(kf.poses6[0])

    fns = [proj, proj_seg, front, front_feat, perceive, odo,
           lambda: mapping.scan_to_map(cfg, T0, c, cm, surf_q, surf_qm,
                                       *sub),
           lambda: mapping.downsample_scan(
               cfg, p.odo.corner_last.xyz, p.odo.corner_last.mask,
               p.odo.surf_last.xyz, p.odo.surf_last.mask, zeros, none),
           lambda: mapping.build_submap(cfg, kf),
           lambda: scan_context.make_descriptor(*scan(), cfg.sc),
           lambda: scan_context.detect(cfg, m.bank, m.bank.desc[0]),
           lambda: loop.history_submap(cfg, kf, first),
           lambda: loop.verify(cfg, kf, cur, first, place),
           lambda: posegraph.solve(cfg, kf.poses6, kf.count, kf.odom_z,
                                   m.loops)]
    return [(name, fn, reps) for name, fn in zip(STAGES, fns)]


def run(cfg, scans, valids, device, card, engine=None, reps=N,
        profile=True):
    """Measure and print the 14 stages; returns ``measure``'s rows.
    ``engine``: a warm engine (default: one driven over the scans)."""
    if engine is None:
        engine = profile_iters.warm_engine(cfg, scans, valids, device)
    rows = profile_stages.measure(
        stage_parts(cfg, scans, valids, engine, reps), device, profile)
    for r in rows:
        print(f"{r['name']:42s} device_ms="
              f"{profile_iters.num(r['device_ms'])} "
              f"ms_synchronized={r['sync_ms']:.3f} "
              f"host_ms={r['host_ms']:.3f} "
              f"launches={profile_iters.num(r['launches'], 'd')} "
              f"kernel_ms={profile_iters.num(r['kernel_ms'])} "
              f"(n={r['n']}) [{card}]", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    cfg = synthetic_config()
    scans, valids, _ = make_scans(cfg)
    run(cfg, scans, valids, device, bench.card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
