"""Sub-operations of the hot stages timed in isolation (the counterpart of
the JAX package's ``tools/profile_micro.py``).

    python -m sc_lego_loam_tpu_torch.tools.profile_micro [--device cuda]

Six groups on the last of two scans of ``synthetic_config()``'s figure-8
(radius 30 m, 0.05 laps, seed 11): the dispatch of a tiny op and a 256 MB
elementwise pass (``x + 1``: its GB/s, bytes read and written, beside the
card's 3.35 TB/s); projection (ordered and unordered), ground,
segmentation (6 and 3 rounds) and compaction; feature extraction and
curvature; the odometry's correspondence searches at 2048 x 4096
(``odometry._find_corner``, ``_find_surf``, ``_sqdist``); the Scan Context
descriptor by scatter (``scan_context.make_descriptor``) against the JAX
tool's broadcast-compare alternative (``desc_bcast``, ported with it; the
two must agree) and ``voxel_decimate`` against its ``thin_group`` at 717k
points; then the CUDA kNN (``cuda_knn.make_knn``: target prep + kernel) at
12288 x 65536 k=5 and 8192 x 32768 k=1, and ``se3.best_fit_transform``
(Horn's method on the symeig kernel) at 8192 points.

``device_ms``: CUDA events around a replayed CUDA graph of n calls, per
call (``knn_tune.graph_ms``: no host time between the launches counts);
``host_ms``: n eager calls back to back on the host clock, a synchronize
closing the window (the dispatch cost where the device is faster).
``--device`` defaults to ``cuda`` and fails without a card; on the CPU
only ``host_ms`` is measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import odometry
from ..config import synthetic_config
from ..models import scan_context
from ..ops import (compaction, cuda_knn, features as features_op, ground,
                   projection, segmentation, voxel)
from ..ops.features import FeatureCloud
from ..utils import se3, synthetic
from . import bench

CARD_BYTES_PER_S = 3.35e12      # the H100 SXM's HBM3 rate
BIG = 64 * 1024 * 1024          # floats of the 256 MB pass
SIZES = dict(big=BIG, corr=(2048, 4096), voxel=50 * 14336,
             voxel_pad=65536, knn5=(12288, 65536), knn1=(8192, 32768),
             fit=8192)


def desc_bcast(points, mask, sc):
    """The Scan Context descriptor by broadcast-compare: each of 16 point
    chunks against every bin, a max over the chunk, then over the chunks
    (the JAX tool's alternative to the scatter-max)."""
    R, S = sc.num_ring, sc.num_sector
    if points.shape[0] > sc.max_input_points:
        stride = -(-points.shape[0] // sc.max_input_points)
        points = points[::stride]
        mask = mask[::stride]
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    rho = torch.sqrt(x * x + y * y)
    theta = torch.remainder(torch.rad2deg(torch.atan2(y, x)), 360.0)
    ok = mask & (rho < sc.max_radius) & (rho > 1e-3)
    ring = torch.clamp((rho / (sc.max_radius / R)).to(torch.int32), 0, R - 1)
    sector = torch.clamp((theta / (360.0 / S)).to(torch.int32), 0, S - 1)
    flat = torch.where(ok, ring * S + sector, R * S)
    val = torch.where(ok, z + sc.lidar_height, -1e9)
    C = 16
    chunk = points.shape[0] // C
    fb = flat[:C * chunk].reshape(C, 1, chunk)
    vb = val[:C * chunk].reshape(C, 1, chunk)
    bins = torch.arange(R * S, device=points.device)[None, :, None]
    m = torch.where(fb == bins, vb, -1e9).amax(-1).amax(0)
    return torch.where(m <= -1e8, 0.0, m).reshape(R, S)


def thin_group(points, mask, out_pad):
    """Decimation by fixed groups: the first valid point of each of
    ``out_pad`` consecutive groups (the JAX tool's alternative to the voxel
    filter)."""
    Mm = points.shape[0]
    gsz = -(-Mm // out_pad)
    pad = gsz * out_pad - Mm
    p = torch.cat([points, points.new_zeros((pad, 3))])
    mk = torch.cat([mask, mask.new_zeros((pad,))])
    pg = p.reshape(out_pad, gsz, 3)
    mg = mk.reshape(out_pad, gsz)
    i = mg.to(torch.uint8).argmax(-1)          # the first of the maxima
    ok = torch.take_along_dim(mg, i[:, None], -1)[:, 0]
    out = torch.take_along_dim(pg, i[:, None, None], 1)[:, 0]
    return torch.where(ok[:, None], out, 0.0), ok


def time_part(fn, n, device):
    """(device ms, host ms) per call of ``fn``; device None on the CPU."""
    from .knn_tune import graph_ms

    fn()
    bench.sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    bench.sync(device)
    host = 1e3 * (time.perf_counter() - t0) / n
    dev = graph_ms(fn, n) if torch.device(device).type == "cuda" else None
    return dev, host


def parts(cfg, pts, msk, device, sizes=SIZES, seed=0):
    """(group, name, fn, n) of every timed sub-operation, and the two
    descriptors to compare."""
    lid, seg = cfg.lidar, cfg.seg
    rng = np.random.default_rng(seed)

    def cloud(n, scale=20.0):
        return torch.as_tensor(rng.normal(0, scale, (n, 3)),
                               dtype=torch.float32, device=device)

    x = torch.zeros((8, 128), device=device)
    big = torch.zeros((sizes["big"],), device=device)
    img = projection.project_ordered(pts, msk, lid)
    g = ground.ground_mask(img, lid, seg)
    s = segmentation.segment(img, g, lid, seg)
    seg3 = dataclasses.replace(seg, max_label_rounds=3)
    cl, _ = compaction.compact(img, s, g, lid, seg)

    Q, T = sizes["corr"]
    q, tgt = cloud(Q), cloud(T)
    fc = FeatureCloud(
        xyz=tgt, mask=torch.ones(T, dtype=torch.bool, device=device),
        ring=torch.as_tensor(rng.integers(0, 64, T), dtype=torch.int32,
                             device=device),
        rel_time=torch.zeros(T, device=device))
    qmask = torch.ones(Q, dtype=torch.bool, device=device)
    M = sizes["voxel"]
    big_pts = cloud(M, 40.0)
    big_mask = torch.as_tensor(rng.random(M) > 0.2, device=device)
    pad = sizes["voxel_pad"]
    (q5, t5), (q1, t1) = sizes["knn5"], sizes["knn1"]
    q2, t2 = cloud(q5), cloud(t5)
    q3, t3 = cloud(q1), cloud(t1)
    t2m = torch.ones(t5, dtype=torch.bool, device=device)
    t3m = torch.ones(t1, dtype=torch.bool, device=device)
    nf = sizes["fit"]
    qf = cloud(nf)
    wf = torch.ones(nf, device=device)
    ocfg = cfg.odom

    out = [
        ("dispatch", "dispatch (x+1 tiny)", lambda: x + 1.0, 200),
        ("dispatch", f"copy {4 * sizes['big'] >> 20}MB (x+1)",
         lambda: big + 1.0, 10),
        ("frontend", "projection.project_ordered",
         lambda: projection.project_ordered(pts, msk, lid), 30),
        ("frontend", "projection.project (unordered)",
         lambda: projection.project(pts, msk, lid), 30),
        ("frontend", "ground.ground_mask",
         lambda: ground.ground_mask(img, lid, seg), 30),
        ("frontend", "segmentation.segment (6 rounds)",
         lambda: segmentation.segment(img, g, lid, seg), 30),
        ("frontend", "segmentation.segment (3 rounds)",
         lambda: segmentation.segment(img, g, lid, seg3), 30),
        ("frontend", "compaction.compact",
         lambda: compaction.compact(img, s, g, lid, seg), 30),
        ("features", "features.extract (full)",
         lambda: features_op.extract(cl, cfg.feat, cfg.cap), 30),
        ("features", "features.curvature",
         lambda: features_op.curvature(cl, cfg.feat), 30),
        ("odometry", f"odometry._find_corner ({Q}x{T})",
         lambda: odometry._find_corner(q, qmask, fc, ocfg), 30),
        ("odometry", f"odometry._find_surf ({Q}x{T})",
         lambda: odometry._find_surf(q, qmask, fc, ocfg), 30),
        ("odometry", f"sqdist only ({Q}x{T})",
         lambda: odometry._sqdist(q, tgt).min(-1), 30),
        ("descriptor", "sc.make_descriptor (scatter, cur)",
         lambda: scan_context.make_descriptor(pts, msk, cfg.sc), 30),
        ("descriptor", "sc.descriptor (bcast-compare)",
         lambda: desc_bcast(pts, msk, cfg.sc), 30),
        ("voxel", f"voxel_decimate ({M // 1000}k, cur)",
         lambda: voxel.voxel_decimate(big_pts, big_mask, 0.3, pad), 10),
        ("voxel", f"thin_group ({M // 1000}k -> {pad})",
         lambda: thin_group(big_pts, big_mask, pad), 10),
        ("knn", f"cuda_knn {q5}x{t5} k=5",
         lambda: cuda_knn.make_knn(t2, t2m, 5, 4.0)(q2), 10),
        ("knn", f"cuda_knn {q1}x{t1} k=1",
         lambda: cuda_knn.make_knn(t3, t3m, 1, 64.0)(q3), 10),
        ("fit", f"se3.best_fit_transform ({nf})",
         lambda: se3.best_fit_transform(qf, qf + 0.01, wf), 30),
    ]
    return out


def run(cfg, pts, msk, device, card, sizes=SIZES, reps=None):
    """Time and print every part; returns its rows (name, group,
    device_ms, host_ms, n) and whether the two descriptors agree.
    ``reps`` overrides every part's call count."""
    pts = torch.as_tensor(pts, device=device)
    msk = torch.as_tensor(msk, device=device)
    rows = []
    for group, name, fn, n in parts(cfg, pts, msk, device, sizes):
        n = reps or n
        dev, host = time_part(fn, n, device)
        rows.append(dict(group=group, name=name, device_ms=dev,
                         host_ms=host, n=n))
        extra = ""
        if name.startswith("copy"):
            nbytes = 2 * 4 * sizes["big"]       # read + write
            gbs = nbytes / (dev if dev else host) / 1e6
            rows[-1]["gb_per_s"] = gbs
            extra = (f" {gbs:.1f} GB/s ({'device' if dev else 'host'} ms; "
                     f"the card's rate {CARD_BYTES_PER_S / 1e9:.0f} GB/s)")
        print(f"{name:44s} device_ms="
              f"{'n/a' if dev is None else format(dev, '9.3f')} "
              f"host_ms={host:9.3f} (n={n}){extra} [{card}]", flush=True)
    d1 = desc_bcast(pts, msk, cfg.sc)
    d0 = scan_context.make_descriptor(pts, msk, cfg.sc)
    same = bool(torch.allclose(d1, d0))
    print(f"   bcast == scatter: {same}", flush=True)
    return rows, same


def make_scans(cfg):
    return synthetic.make_sequence(cfg.lidar, 2, trajectory="figure8",
                                   radius=30.0, loops=0.05, noise=0.01,
                                   seed=11, shuffle=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    cfg = synthetic_config()
    scans, valids, _ = make_scans(cfg)
    run(cfg, scans[-1], valids[-1], device, bench.card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
