"""A throwaway tiny cell for the CPU tests: the port's tiny sensor
(16 x 128) on the figure-8, written as new files beside copies of the
benchmark's own, then planned by name as any cell is."""

import dataclasses
import json
import os
import shutil

from sc_lego_loam_tpu_torch.config import tiny_test_config
from slambench import plan

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

# Limits for the tiny sensor (16 x 128), which registers coarsely on the
# CPU: its sound steps read a median of ~0.1 m, a worst of ~0.55 m.  A
# planted fault moves every step by the ~0.85 m a scan travels, or one
# pose by 10 m.
TINY_LIMITS = {"scan_step_p50_m": 0.4, "scan_step_max_m": 5.0,
               "pose_rigidity": 1e-3, "kf_missing_share": 0.5,
               "kf_step_max_m": 5.0, "loop_miss_share": 0.5,
               "false_factor_share": 0.5,
               "factor_rigidity": 1e-3}


def copy_tree(dst):
    """The benchmark's data and readers, and BENCHMARK.json, under dst."""
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(dst, d))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


def add_cell(dst, name="tiny", engine="single", streams=1, drive_scans=14,
             traffic="fig8.replay", metrics=("perception_ms",),
             revisit_gap_s=None, imu_stream=None, imu_enabled=None):
    """New files for a config ``name``, and a cell ``name.<traffic>`` in
    dst's BENCHMARK.json reporting ``metrics``; returns the planned
    cell.  ``revisit_gap_s`` sets the judge's revisit gap and the loop
    detector's radius-search time gap together.  ``imu_stream``: the
    configuration's IMU sensor block, with ``pipeline.imu.enabled`` on
    unless ``imu_enabled`` says otherwise."""
    cfg = json.load(open(os.path.join(dst, "configs",
                                      "mulran-os1-64.json")))
    cfg.update(name=name, engine=engine, streams=streams,
               drive_scans=drive_scans,
               pipeline=dataclasses.asdict(tiny_test_config()))
    if imu_stream is not None:
        cfg["imu_stream"] = imu_stream
    cfg["pipeline"]["imu"]["enabled"] = (imu_stream is not None
                                         if imu_enabled is None
                                         else imu_enabled)
    if revisit_gap_s is not None:
        cfg["revisit_gap_s"] = revisit_gap_s
        cfg["pipeline"]["loop"]["rs_time_gap"] = revisit_gap_s
    json.dump(cfg, open(os.path.join(dst, "configs", name + ".json"), "w"))
    cell = f"{name}.{traffic}"
    json.dump(TINY_LIMITS, open(os.path.join(dst, "limits",
                                             cell + ".json"), "w"))
    path = os.path.join(dst, "BENCHMARK.json")
    b = json.load(open(path))
    b["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                           "chips": 1, "why": "a throwaway tiny cell"})
    e2e = "scans_per_s" if traffic.endswith("replay") \
        else "scan_latency_p95_ms"
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in (e2e,) + tuple(metrics):
            m["workloads"].append(cell)
    json.dump(b, open(path, "w"))
    return plan.load_cell(cell, path, dst)


def add_loop_cell(dst, name="tinyloop"):
    """A tiny cell that closes loops within 70 scans: a new mix, the
    figure-8 at radius 8 m and 50 scans a lap, and a revisit gap of 2 s
    (its first revisit comes at scan ~20)."""
    mix = json.load(open(os.path.join(dst, "traffic", "fig8.replay.json")))
    mix.update(radius=8.0, scans_per_lap=50)
    json.dump(mix, open(os.path.join(dst, "traffic", "small8.replay.json"),
                        "w"))
    return add_cell(dst, name, drive_scans=70, traffic="small8.replay",
                    revisit_gap_s=2.0)
