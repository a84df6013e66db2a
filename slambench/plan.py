"""What a cell runs, found by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration, its traffic mix and the metrics
it reports; each of those is a file of its own under ``slambench/``:

    configs/<config>.json      the deployment: engine kind, streams, the
                               engine's settings as run, warm-up and drive
                               length, what was assumed, and with the IMU
                               on its sensor (``imu_stream``: ``rate_hz``,
                               ``noise_rpy``, ``noise_acc``, ``noise_gyro``)
    traffic/<traffic>.json     the drive's parameters, the mode (replay or
                               latency) and the scans of each traced phase
                               (``trace_handin_scans``, latency only;
                               ``trace_device_scans``,
                               ``trace_program_scans``)
    limits/<workload>.json     the limit of each number ``correct`` compares
    metrics/<metric>.py        the reader of one per-layer metric

A later cell, mix or metric is new files and new entries: nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # entries of BENCHMARK.json this cell reports
    per_layer: list
    readers: dict          # per-layer metric name -> read(record)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def check_config(config: dict):
    """Refuse a configuration whose IMU stream and engine disagree: an
    ``imu_stream`` block exactly where ``pipeline.imu.enabled`` holds, and
    no fleet (``BatchEngine`` refuses the IMU)."""
    name = config.get("name", "?")
    stream = "imu_stream" in config
    enabled = bool(config["pipeline"]["imu"]["enabled"])
    if stream != enabled:
        raise ValueError(
            f"configuration {name}: imu_stream "
            f"{'given' if stream else 'missing'} with pipeline.imu.enabled "
            f"{enabled}; give both or neither")
    if enabled and config["engine"] != "single":
        raise ValueError(f"configuration {name}: engine "
                         f"{config['engine']!r} with the IMU on; only a "
                         "single engine takes an IMU")


def load_reader(name: str, root: str = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(workload: str, benchmark: str, root: str = HERE) -> Cell:
    """The cell ``workload`` of the benchmark file ``benchmark``, its files
    under ``root``."""
    bench = _load(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    w = cells[workload]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    config = _load(os.path.join(root, "configs", w["config"] + ".json"))
    check_config(config)
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=_load(os.path.join(root, "traffic", w["traffic"] + ".json")),
        limits=_load(os.path.join(root, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, workload)],
        per_layer=per_layer,
        readers={m["name"]: load_reader(m["name"], root) for m in per_layer})
