"""``utils/profiling.py`` of the port: ``StageTimer`` gives the JAX package's
numbers for the same samples, the engine's tracer (``engine.trace``)
records its calls and their steps, and ``device_trace`` writes a
``torch.profiler`` trace."""

import json
import os
import types

import numpy as np
import torch

from sc_lego_loam_tpu.utils import profiling as jprof
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.tools import profile_stages
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
    assert not engine.trace.enabled            # off until asked for
    engine.trace.on()
    n = cfg.lidar.max_points
    for i in range(9):              # 3 mapping ticks, 1 loop tick
        engine.process_scan(np.zeros((n, 3), np.float32), np.zeros(n, bool),
                            t=0.1 * i)
    got = engine.trace.summary(skip_first=0)
    assert {k: v["n"] for k, v in got.items()} == {
        "process_scan": 9, "stage_scan": 9, "perception_step": 9,
        "mapping_step": engine.map_ticks, "loop_step": engine.loop_ticks}
    assert engine.map_ticks == 3 and engine.loop_ticks == 1
    assert "perception_step" in engine.trace.table()
    drained = engine.trace.drain()
    assert len(drained["scans"]) == 9
    assert sum(s["loop_tick"] is not None for s in drained["scans"]) == 1
    assert engine.trace.summary() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(logdir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_one_profiler_session_splits_by_part():
    """``profile_stages.split_by_part`` gives each part of one session its
    own events (CPU ops stand in for the card's kernels here)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(4)
    adds = [3, 0, 5]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, n in enumerate(adds):
            with record_function(f"{profile_stages.PART_TAG}{i}"):
                for _ in range(n):
                    x = torch.add(x, 1)
                torch.mul(x, 2)
    got = profile_stages.split_by_part(prof.events(), len(adds),
                                       lambda e: e.name == "aten::add")
    assert [n for n, _ in got] == adds
    assert all(ms >= 0 for _, ms in got)
    muls = profile_stages.split_by_part(prof.events(), len(adds),
                                        lambda e: e.name == "aten::mul")
    assert [n for n, _ in muls] == [1, 1, 1]

    # The card's kernels can read a few ms early or late against the
    # host's ranges; parts GAP_S apart keep each kernel with its own part.
    def ev(name, start, end):
        span = types.SimpleNamespace(start=start, end=end,
                                     elapsed_us=lambda: end - start)
        return types.SimpleNamespace(name=name, time_range=span)

    gap = 1e6 * profile_stages.GAP_S
    spans = [(gap * (i + 1), gap * (i + 1) + 4000.0) for i in range(3)]
    events = [ev(f"{profile_stages.PART_TAG}{i}", a, b)
              for i, (a, b) in enumerate(spans)]
    for i, (a, b) in enumerate(spans):
        for skew in (-5000.0, 0.0, 5000.0):
            events += [ev("kernel", a + 10 + skew, a + 30 + skew)] * (i + 1)
    got = profile_stages.split_by_part(events, 3, lambda e: e.name == "kernel")
    assert [n for n, _ in got] == [3, 6, 9]
    np.testing.assert_allclose([ms for _, ms in got], [0.06, 0.12, 0.18])
