"""DCC-scale capacity runway on the card (the counterpart of the JAX
package's ``tools/run_capacity.py``): a 16,384-keyframe bank fills and
drops without clobbering, and a full-size bank is allocated, filled and
worked on.

    python -m sc_lego_loam_tpu_torch.tools.run_capacity [--device cuda]
        [--full-runway]

Part 1: a tiny-sensor engine (``tiny_test_config()``) with
``max_keyframes=16384``, ``keyframe_dist=0`` and ``process_interval=0`` (every
scan a mapping tick and a keyframe) and loop closure off, driven to 16,384
keyframes plus 64 over the cap.  At a few hundred ms of launches a scan,
16,448 ``process_scan`` calls take hours, so the bank is first filled to
16,384 - 16 rows through the mapping layer's own ``mapping.insert_keyframe``
(the first 8 rows from 8 driven scans, the rest their clouds at poses that
advance along the track), and the last 16 + 64 scans go through
``process_scan``: the cap, the drop counter and the host warning run end to
end.  ``--full-runway`` drives every one of the 16,448 scans instead.
Checks: ``count == 16384``, ``kf_dropped == 64``, the "keyframe bank full"
warning, and the newest slot bit-equal to what it held when the bank filled.

Part 2: the full-size OS1-64 engine (``synthetic_config()``) at 16,384
keyframes: its state's bytes, one scan through it; then the bank FILLED
(count = 16,384, rows tiled from the keyframes of a short drive, each lap of
copies moved along a track), one ``mapping_step`` and one ``loop_step`` over
the full bank timed (CUDA events and host clock); then the loop-factor bank
driven past its 256 slots with ``posegraph.add_loop`` (the worst residual
evicted), the "loop-factor bank full" warning checked, and one
``posegraph.solve`` over the 16,384 nodes and 256 factors timed and checked
finite.

``--device`` defaults to ``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import warnings

import numpy as np
import torch

from .. import mapping, pipeline, posegraph
from ..config import synthetic_config, tiny_test_config
from ..ops import cuda_knn
from ..pipeline import SlamEngine
from ..utils import export, se3, synthetic
from . import bench

K = 16384
EXTRA = 64           # scans past the cap
TAIL = 16            # inserts before the cap that process_scan drives
N_SRC = 8            # part 1: scans driven for the clouds the prefill copies
SRC_SCANS = 24       # part 2: scans of the drive the full bank is tiled from
LOOPS_OVER = 44      # part 2: loop factors added past max_loops
LAP_SHIFT_M = 200.0  # part 2: each lap of copies moves this far along x


def _fields(kf, i):
    """Row ``i`` of every bank field of a keyframe store (clones)."""
    return {f: getattr(kf, f)[i].clone() for f in mapping.KeyframeStore._fields
            if f != "count"}


def runway_config(base, k=K, extra=EXTRA):
    """``base`` with a k-keyframe bank, a keyframe on every scan and loop
    closure off (the JAX tool's part 1 settings)."""
    return base.replace(
        cap=dataclasses.replace(base.cap, max_keyframes=k,
                                max_scans=k + extra + 8),
        mapping=dataclasses.replace(base.mapping, keyframe_dist=0.0,
                                    process_interval=0.0),
        loop=dataclasses.replace(base.loop, enabled=False))


def prefill(cfg, kf, stop, n_src, step):
    """Rows ``count`` .. ``stop``-1 of ``kf`` through
    ``mapping.insert_keyframe``: row i holds keyframe (i % n_src)'s clouds
    at its pose moved (i // n_src) * n_src * ``step`` m along x, at time
    0.1 i.  Returns the store."""
    dev = kf.poses6.device
    start = int(kf.count)
    rows = torch.arange(start, stop, device=dev)
    src = rows % n_src
    poses = se3.pose6_to_mat(kf.poses6[src])
    poses[:, 0, 3] += (rows // n_src).float() * (n_src * step)
    times = 0.1 * rows.float()
    clouds = [getattr(kf, f)[:n_src].clone() for f in mapping.SHARDED_FIELDS]
    yes = torch.ones((), dtype=torch.bool, device=dev)
    for n, i in enumerate(range(start, stop)):
        j = i % n_src
        kf, _ = mapping.insert_keyframe(cfg, kf, yes, poses[n], times[n],
                                        *(c[j] for c in clouds))
    return kf


def check(ok: bool, what: str):
    """A check of the runway; raises (under ``-O`` too) when it fails."""
    if not ok:
        raise RuntimeError(f"run_capacity: {what}")


def _bank_full_warnings(engine, what):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        engine._check_caps()
    return [w for w in rec if what in str(w.message)]


def part1(device, card, cfg=None, k=K, extra=EXTRA, tail=TAIL, n_src=N_SRC,
          full_runway=False):
    """The keyframe runway on ``cfg`` (default ``tiny_test_config()``) made
    a ``runway_config``.  Returns a dict of what it found; raises
    RuntimeError when a check fails."""
    cfg = runway_config(cfg or tiny_test_config(), k, extra)
    step = 0.3
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, n_src, trajectory="straight", step=step, noise=0.01,
        seed=4)
    engine = SlamEngine(cfg, device=device)
    n = k + extra
    t0 = time.perf_counter()
    drive_from = 0 if full_runway else k - tail
    for i in range(min(n_src, drive_from)):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    if drive_from > n_src:
        engine.m = engine.m._replace(kf=prefill(
            cfg, engine.m.kf, drive_from, n_src, step))
    bench.sync(engine.device)
    fill_s = time.perf_counter() - t0
    newest = None
    t1 = time.perf_counter()
    for i in range(drive_from, n):
        engine.process_scan(scans[i % n_src], valids[i % n_src], t=i * 0.1)
        if i == k - 1:
            newest = _fields(engine.m.kf, k - 1)
    bench.sync(engine.device)
    drive_s = time.perf_counter() - t1
    got_warning = _bank_full_warnings(engine, "keyframe bank full")
    count, dropped = int(engine.m.kf.count), int(engine.m.kf_dropped)
    traj = engine.trajectory_array()
    after = _fields(engine.m.kf, k - 1)
    intact = bool(engine.m.kf.corner_mask[k - 1].any()) and all(
        torch.equal(newest[f], after[f]) for f in after)
    prefilled = max(0, drive_from - n_src)
    print(f"capacity part 1 ({cfg.lidar.name} sensor, max_keyframes={k}, "
          f"loop closure off): {prefilled} rows through "
          f"mapping.insert_keyframe after {min(n_src, drive_from)} scans, "
          f"{fill_s:.2f} s; {n - drive_from} scans through process_scan in "
          f"{drive_s:.2f} s ({1e3 * drive_s / (n - drive_from):.1f} ms a "
          f"scan); count={count} kf_dropped={dropped} warning_fired="
          f"{bool(got_warning)} newest_slot_intact={intact} "
          f"trajectory_finite={bool(np.isfinite(traj).all())} [{card}]",
          flush=True)
    check(count == k, f"count {count}, not {k}")
    check(dropped == extra, f"kf_dropped {dropped}, not {extra}")
    check(bool(got_warning), "the keyframe bank full warning did not fire")
    check(bool(np.isfinite(traj).all()), "trajectory is not finite")
    check(intact, "the newest keyframe slot changed after the bank filled")
    return dict(count=count, dropped=dropped, prefilled=prefilled,
                fill_s=fill_s, drive_s=drive_s)


def state_bytes(engine):
    """Bytes of the engine's device state: (mapper state, whole state)."""
    def size(leaves):
        return sum(x.numel() * x.element_size() for _, x in leaves)
    m = size(export.state_leaves(engine.m))
    return m, m + size(export.state_leaves(engine.p))


def fill_bank(engine, src):
    """Every row of ``engine``'s keyframe and descriptor banks from
    ``src``'s live keyframes tiled in order, lap L of the copies moved
    ``LAP_SHIFT_M`` * L m along x; times 0.3 s apart, odometry factors and
    poses consistent with the tiled poses, the mapped pose and correction at
    the last row.  Returns the last row's source keyframe index."""
    cfg = engine.config
    K_ = cfg.cap.max_keyframes
    dev = engine.device
    kf, bank = engine.m.kf, engine.m.bank
    n_src = int(src.m.kf.count)
    rows = torch.arange(K_, device=dev)
    idx = rows % n_src
    for f in mapping.SHARDED_FIELDS:
        torch.index_select(getattr(src.m.kf, f), 0, idx, out=getattr(kf, f))
    torch.index_select(src.m.bank.desc, 0, idx, out=bank.desc)
    torch.index_select(src.m.bank.ringkey, 0, idx, out=bank.ringkey)
    X = se3.pose6_to_mat(src.m.kf.poses6[idx])
    X[:, 0, 3] += (rows // n_src).float() * LAP_SHIFT_M
    kf.poses6.copy_(se3.mat_to_pose6(X))
    kf.times.copy_(0.3 * rows.float())
    kf.odom_pose.copy_(X)
    kf.odom_z[0] = X[0]
    kf.odom_z[1:] = se3.mat_inv(X[:-1]) @ X[1:]
    full = torch.full((), K_, dtype=torch.int32, device=dev)
    engine.m = engine.m._replace(
        kf=kf._replace(count=full), bank=bank._replace(count=full.clone()),
        pose=X[-1].clone(), last_kf_pose=X[-1].clone(),
        correction=X[-1].clone())
    return (K_ - 1) % n_src


def _timed(fn, device):
    """(result, ms by CUDA events, host ms) of one call ending in a
    synchronize, after one call to warm it."""
    fn()
    bench.sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        ev1.record()
    bench.sync(device)
    host_ms = 1e3 * (time.perf_counter() - t0)
    return out, (ev0.elapsed_time(ev1) if cuda else None), host_ms


def _ms(x):
    return "n/a" if x is None else f"{x:.3f}"


def part2(device, card, src, src_scans, src_valids, cfg=None,
          loops_over=LOOPS_OVER):
    """The full-size bank on ``cfg`` (default ``synthetic_config()``),
    filled from ``src``, an engine of the same configuration that has
    driven ``src_scans``.  Returns a dict of what it measured; raises
    RuntimeError when a check fails."""
    cfg = cfg or synthetic_config()
    K_, L = cfg.cap.max_keyframes, cfg.posegraph.max_loops
    engine = SlamEngine(cfg, device=device)
    mapper_b, state_b = state_bytes(engine)
    engine.process_scan(src_scans[0], src_valids[0], t=0.0)
    check(int(engine.m.kf.count) == 1, "the first scan inserted no keyframe")
    print(f"capacity part 2: full-size state ({cfg.lidar.name}, "
          f"max_keyframes={K_}, max_loops={L}): mapper_state_bytes={mapper_b} "
          f"state_bytes={state_b}; one scan through it (count 1) [{card}]",
          flush=True)

    j = fill_bank(engine, src)
    s = min(int(round(float(src.m.kf.times[j]) / 0.1)), len(src_scans) - 1)
    dev = engine.device
    pts = torch.as_tensor(src_scans[s], dtype=torch.float32, device=dev)
    msk = torch.as_tensor(src_valids[s], dtype=torch.bool, device=dev)
    t = torch.full((), 0.3 * K_, device=dev)
    p, odom_pose, out_pts, out_mask, _ = pipeline.perception_step(
        cfg, engine.p, engine.m.correction, pts, msk, t)
    odo = p.odo
    # The scan of the last row's source keyframe, guessed at that row's pose.
    m = engine.m._replace(correction=engine.m.pose @ se3.mat_inv(odom_pose))
    new_m, map_ms, map_host = _timed(lambda: pipeline.mapping_step(
        cfg, m, odo.corner_last.xyz, odo.corner_last.mask, odo.surf_last.xyz,
        odo.surf_last.mask, out_pts, out_mask, odom_pose, pts, msk, t,
        p.imu), dev)
    moved = float(torch.linalg.vector_norm(new_m.pose[:3, 3]
                                           - m.pose[:3, 3]))
    k1 = cuda_knn.launches[1]
    looped, loop_ms, loop_host = _timed(lambda: pipeline.loop_step(cfg, m),
                                        dev)
    k1 = (cuda_knn.launches[1] - k1) // 2     # the warm call and the timed
    closed = int(looped.loops_closed) - int(m.loops_closed)
    print(f"capacity part 2, full bank (count={int(m.kf.count)}, "
          f"{int(src.m.kf.count)} keyframes tiled, laps {LAP_SHIFT_M} m "
          f"apart): mapping_step ms={_ms(map_ms)} (CUDA events) "
          f"host_ms={map_host:.3f} (scan {s} of keyframe {j}, guessed at the "
          f"last row's pose, mapped {moved:.3f} m from it); loop_step "
          f"ms={_ms(loop_ms)} host_ms={loop_host:.3f} (Scan Context over "
          f"{K_} descriptors, radius detection over {K_} poses; k=1 kNN "
          f"calls {k1}, closed {closed}) [{card}]", flush=True)
    check(int(new_m.kf.count) == K_, f"count {int(new_m.kf.count)} after "
          "a mapping step on the full bank")
    check(bool(torch.isfinite(new_m.pose).all())
          and bool(torch.isfinite(looped.kf.poses6).all()),
          "a step over the full bank is not finite")

    poses6, n_loops = m.kf.poses6, L + loops_over
    gen = torch.Generator(device=dev).manual_seed(0)
    i = torch.randint(K_ // 2, K_, (n_loops,), device=dev, generator=gen)
    jj = torch.remainder(i - torch.randint(1, K_ // 2, (n_loops,), device=dev,
                                           generator=gen), K_)
    X = se3.pose6_to_mat(poses6)
    noise = 0.05 * torch.randn((n_loops, 6), device=dev, generator=gen)
    Z = se3.mat_inv(X[i]) @ X[jj] @ se3.se3_exp(noise)
    loops = m.loops
    t0 = time.perf_counter()
    for n in range(n_loops):
        loops = posegraph.add_loop(loops, i[n], jj[n], Z[n], poses6)
    bench.sync(dev)
    add_ms = 1e3 * (time.perf_counter() - t0) / n_loops
    engine.m = m._replace(loops=loops)
    warned = _bank_full_warnings(engine, "loop-factor bank full")
    solved, solve_ms, solve_host = _timed(lambda: posegraph.solve(
        cfg, poses6, m.kf.count, m.kf.odom_z, loops), dev)
    finite = bool(torch.isfinite(solved).all())
    print(f"capacity part 2, loop bank: {n_loops} add_loop calls into "
          f"{L} slots ({add_ms:.3f} host ms each, worst residual evicted "
          f"past the cap) count={int(loops.count)} warning_fired="
          f"{bool(warned)}; posegraph.solve over {K_} nodes and {L} factors "
          f"ms={_ms(solve_ms)} host_ms={solve_host:.3f} poses_finite={finite} "
          f"max_move_m="
          f"{float((solved - poses6)[:, 3:].abs().max()):.3e} [{card}]",
          flush=True)
    check(int(loops.count) == n_loops > L, f"loop count {int(loops.count)}")
    check(bool(warned), "the loop-factor bank full warning did not fire")
    check(finite, "the re-solve over the full bank is not finite")
    return dict(mapper_bytes=mapper_b, state_bytes=state_b, map_ms=map_ms,
                loop_ms=loop_ms, solve_ms=solve_ms, loops=int(loops.count))


def source_drive(device, cfg=None, n=SRC_SCANS):
    """The drive part 2's bank is tiled from: ``n`` scans of a straight
    OS1-64 sequence (0.4 m a scan) through ``cfg``'s engine.  Returns
    (engine, scans, valids)."""
    cfg = cfg or synthetic_config()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, n, trajectory="straight", step=0.4, noise=0.01, seed=4,
        shuffle=False, workers=8)
    engine = SlamEngine(cfg, device=device)
    for i in range(n):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    return engine, scans, valids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-runway", action="store_true",
                    help="drive all 16,448 scans of part 1 through "
                    "process_scan (hours on the card)")
    args = ap.parse_args(argv)
    device = str(bench.require_device(args.device))
    card = bench.card_line(device)
    src, scans, valids = source_drive(device)
    part2(device, card, src, scans, valids)
    del src
    part1(device, card, full_runway=args.full_runway)
    print("run_capacity: every check passed", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
