"""Dataset sequence runners: drive SlamEngine over real scan streams (port
of ``sc_lego_loam_tpu/runner.py``).

Streams MulRan raw-layout scans (``utils/mulran.py``, through the native
prefetching loader of ``native/scloam_io.cpp`` when it can be built) into
the engine and reports scans/s, ATE against the dataset's ground truth,
keyframe and loop-closure counts.  Usable as a library (the tests drive it
on generated MulRan-format fixtures) and through
``python -m sc_lego_loam_tpu_torch.tools.run_mulran``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable

import numpy as np
import torch

from .config import PipelineConfig, default_config
from .pipeline import SlamEngine
from .utils import evaluate, mulran, native_io


def mulran_engine_config() -> PipelineConfig:
    """OS1-64 config for MulRan raw scans: unordered projection (the .bin
    layout interleaves beams), de-skew on (real spinning lidar)."""
    return default_config()


def _wait(engine: SlamEngine):
    """Until the device has finished what was launched (nothing to wait
    for on the CPU)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def run_stream(engine: SlamEngine,
               stream: Iterable[tuple[float, np.ndarray, np.ndarray]],
               warmup: int = 6, progress_every: int | None = None):
    """Feed (t, points, mask) tuples through the engine.

    Returns a result dict with the estimated trajectory, scans/s measured
    after ``warmup`` scans over a window that ends with the device idle,
    and the engine's counters."""
    n = 0
    t_wall = None
    pose = None
    for t, pts, mask in stream:
        pose = engine.process_scan(pts, mask, t=float(t))
        n += 1
        if n == warmup:
            _wait(engine)
            t_wall = time.time()
        if progress_every and n % progress_every == 0:
            p = pose[:3, 3].cpu().numpy()
            print(f"scan {n:5d}: pos=({p[0]:8.2f},{p[1]:8.2f},{p[2]:7.2f}) "
                  f"kf={int(engine.map.kf.count)} "
                  f"loops={int(engine.loops_closed)}", flush=True)
    if pose is not None:
        _wait(engine)
    fps = (n - warmup) / max(time.time() - t_wall, 1e-9) \
        if t_wall is not None and n > warmup else float("nan")
    est = engine.trajectory_array()
    return {
        "scans": n,
        "fps": fps,
        "est": est,
        "times": engine.trajectory_times(),
        "keyframes": int(engine.map.kf.count),
        "loops_closed": int(engine.loops_closed),
    }


def gt_at_times(root: str, times: np.ndarray) -> np.ndarray | None:
    """Ground-truth poses at the scan timestamps (nearest).  Returns
    (N,4,4), or None when the sequence ships no global_pose.csv."""
    if not os.path.exists(os.path.join(root, "global_pose.csv")):
        return None
    gt_ts, gt_poses = mulran.load_gt_poses(root)
    idx = np.searchsorted(gt_ts, times)
    idx = np.clip(idx, 0, len(gt_ts) - 1)
    prev = np.clip(idx - 1, 0, len(gt_ts) - 1)
    pick = np.where(
        np.abs(gt_ts[prev] - times) < np.abs(gt_ts[idx] - times), prev, idx)
    return gt_poses[pick]


def run_mulran(root: str, config: PipelineConfig | None = None,
               limit: int | None = None, use_native: bool = True,
               loop_enabled: bool = True,
               progress_every: int | None = None, device="cuda") -> dict:
    """Run the full engine over one MulRan sequence directory.

    Returns the ``run_stream`` result dict plus ``ate_rmse_m`` when ground
    truth is available, ``loader`` (``"native"`` or ``"python"``: the
    native loader serves when ``use_native`` and it could be built) and
    the ``engine``."""
    cfg = config or mulran_engine_config()
    if not loop_enabled:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=False))
    if not mulran.available(root):
        raise FileNotFoundError(
            f"no MulRan sequence at {root} (need sensor_data/Ouster/*.bin)")

    files = mulran.scan_files(root)
    if limit is not None:
        files = files[:limit]
    times = np.asarray(
        [int(os.path.basename(f).split(".")[0]) * 1e-9 for f in files])
    # The engine keeps time in float32 device buffers; epoch-scale MulRan
    # timestamps (~1.57e9 s) collapse at float32 resolution (~128 s), so
    # feed sequence-relative time and keep the float64 epoch times on the
    # host for the ground-truth lookup.
    t_rel = times - times[0] if len(times) else times
    native = use_native and native_io.available()

    def stream():
        if native:
            with native_io.NativeScanLoader(files,
                                            cfg.lidar.max_points) as loader:
                for t, (pts, mask) in zip(t_rel, loader):
                    yield t, pts, mask
        else:
            for t, f in zip(t_rel, files):
                pts, mask = mulran.load_scan(f, cfg.lidar)
                yield t, pts, mask

    engine = SlamEngine(cfg, device=device)
    res = run_stream(engine, stream(), progress_every=progress_every)
    res["sequence"] = root
    res["loader"] = "native" if native else "python"
    gt = gt_at_times(root, times[:len(res["est"])])
    if gt is not None and len(gt) == len(res["est"]) and len(gt) >= 3:
        res["ate_rmse_m"] = evaluate.ate_rmse(res["est"], gt)
        res["gt_length_m"] = evaluate.trajectory_length(gt)
    res["engine"] = engine
    return res
