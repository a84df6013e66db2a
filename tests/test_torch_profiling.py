"""``utils/profiling.py`` of the port: ``StageTimer`` gives the JAX package's
numbers for the same samples, the engine records its three stages, and
``device_trace`` writes a ``torch.profiler`` trace."""

import json
import os

import numpy as np
import torch

from sc_lego_loam_tpu.utils import profiling as jprof
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def test_stage_timer_matches_the_jax_package():
    rng = np.random.default_rng(0)
    jt, tt = jprof.StageTimer(), tprof.StageTimer()
    for name, n in (("perception", 12), ("mapping", 4), ("loop", 1)):
        for x in rng.uniform(1e-3, 5e-2, n):
            jt.record(name, float(x))
            tt.record(name, float(x))
    for skip in (0, 1, 2):
        assert tt.summary(skip) == jt.summary(skip)
        assert tt.table(skip) == jt.table(skip)
    with tt.stage("mapping"):
        pass
    assert tt.summary(0)["mapping"]["n"] == 5


def test_engine_times_its_stages():
    cfg = tiny_test_config()
    engine = SlamEngine(cfg, device="cpu")
    n = cfg.lidar.max_points
    for i in range(9):              # 3 mapping ticks, 1 loop tick
        engine.process_scan(np.zeros((n, 3), np.float32), np.zeros(n, bool),
                            t=0.1 * i)
    got = engine.timer.summary(skip_first=0)
    assert {k: v["n"] for k, v in got.items()} == {
        "perception": 9, "mapping": engine.map_ticks,
        "loop": engine.loop_ticks}
    assert engine.map_ticks == 3 and engine.loop_ticks == 1
    assert "perception" in engine.timer.table()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(logdir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
