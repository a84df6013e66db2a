"""The port's 11 diagnostics (``sc_lego_loam_tpu_torch/tools/``: the
counterparts of the root ``tools/`` scripts beside ``bench.py``) rehearsed
on the CPU: each runs through its functions with ``device="cpu"`` on a
few tiny scans and prints its rows, and every time it measures is finite;
without a card and without ``--device cpu`` each one's ``main`` raises.
The parity of their numbers with the JAX tools is
tests/test_torch_diag_parity.py's.

The configuration is ``tiny_test_config()`` with fewer LM, ICP and GN
iterations and smaller submap and ICP pads: the CPU's brute-force kNN over
query x target pads is where these drives spend their time, and a
rehearsal checks that every row is produced, not what it reads."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.tools import (bench, debug_fig8, diag_loops,
                                          diag_real, diag_tiny,
                                          profile_engine2, profile_iters,
                                          profile_latency, profile_micro,
                                          profile_odo, profile_s2m,
                                          tune_research)
from sc_lego_loam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

TOOLS = (profile_iters, profile_odo, profile_s2m, tune_research, diag_loops,
         diag_real, debug_fig8, diag_tiny, profile_micro, profile_latency,
         profile_engine2)
SCANS = 4
MICRO_SIZES = dict(big=1 << 16, corr=(64, 128), voxel=4096, voxel_pad=512,
                   knn5=(64, 256), knn1=(64, 256), fit=64)


def fast_config():
    cfg = tiny_test_config()
    return cfg.replace(
        odom=dataclasses.replace(cfg.odom, max_iterations=3),
        mapping=dataclasses.replace(cfg.mapping, max_iterations=2),
        loop=dataclasses.replace(cfg.loop, icp_max_iterations=2,
                                 check_every_ticks=1),
        posegraph=dataclasses.replace(cfg.posegraph, max_gn_iterations=2),
        cap=dataclasses.replace(cfg.cap, submap_corner_pad=1024,
                                submap_surf_pad=2048, history_pad=2048,
                                icp_query_pad=512))


@pytest.fixture(scope="module")
def drive():
    """A few scans of a small figure-8 and an engine warmed on them."""
    cfg = fast_config()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, 12, trajectory="figure8", radius=12.0, loops=1.05,
        noise=0.01, seed=3, shuffle=not cfg.lidar.ordered)
    scans, valids, gt = scans[:SCANS], valids[:SCANS], gt[:SCANS]
    engine = profile_iters.warm_engine(cfg, scans, valids, "cpu")
    return cfg, scans, valids, gt, engine


def _finite(*xs):
    return all(x is not None and math.isfinite(x) and x >= 0 for x in xs)


def test_profiling_tools_print_their_rows(drive, capsys):
    """profile_iters, profile_odo, profile_s2m, profile_latency and
    profile_micro: every row, its host time finite (no device time on the
    CPU), the grids' fits printed."""
    cfg, scans, valids, _, engine = drive
    grid = [(2, 1), (1, 1), (2, 2)]
    odo_rows, map_rows = profile_iters.run(
        cfg, scans[:2], valids[:2], "cpu", "cpu", odo_grid=grid,
        map_grid=grid, reps=1, engine=engine)
    lf, ls, rows = profile_odo.run(cfg, scans[:2], valids[:2], "cpu", "cpu",
                                   grid=[(1, 1)], reps=1)
    sizes, parts, s2m_map, s2m_odo = profile_s2m.run(
        cfg, scans[:2], valids[:2], "cpu", "cpu", map_grid=[(1, 1)],
        odo_grid=[(1, 1)], n=2, reps=1, engine=engine)
    latency = profile_latency.run(cfg, scans[:2], valids[:2], "cpu", "cpu",
                                  engine=engine, reps=1)
    micro, same = profile_micro.run(cfg, scans[0], valids[0], "cpu", "cpu",
                                    sizes=MICRO_SIZES, reps=1)
    out = capsys.readouterr().out
    timed = odo_rows + map_rows + rows + parts + s2m_map + s2m_odo
    assert [r["name"] for r in odo_rows] == [
        f"odometry it={i} re={r}" for i, r in grid]
    assert all(_finite(r["host_ms"]) and r["device_ms"] is None
               for r in timed)
    assert all(r["name"] in out for r in timed)
    assert "fit odometry host_ms: fixed=" in out
    assert "fit scan_to_map host_ms: fixed=" in out
    assert lf.sum() > 0 and len(lf) == cfg.lidar.n_scan and ls.sum() > 0
    assert sizes[:2] == (1024, 2048) and sizes[3] > 0
    assert [p["part"] for p in parts] == ["knn surf", "knn corner",
                                          "surf geometry", "corner geometry"]
    assert [r["name"] for r in latency] == list(profile_latency.STAGES)
    assert all(_finite(r["host_ms"], r["sync_ms"]) for r in latency)
    assert all(r["name"] in out for r in latency)
    assert len(micro) == 20 and all(_finite(r["host_ms"]) for r in micro)
    assert same and "bcast == scatter: True" in out
    assert "GB/s" in out


def test_drive_tools_print_their_rows(drive, capsys, monkeypatch):
    """tune_research, diag_real, profile_engine2, diag_tiny, diag_loops and
    debug_fig8 over the drive (the bench's sequences are the drive's)."""
    cfg, scans, valids, gt, _ = drive
    monkeypatch.setattr(bench, "get_sequence",
                        lambda lidar, n, **kw: (scans[:n], valids[:n],
                                                gt[:n]))
    variants = tune_research.run(["base", "exact"], [11], "cpu", "cpu",
                                 n_scans=3, warm=1, base=fast_config)
    real = []
    for v in ("odo", "ordered"):
        vcfg = diag_real.variant_config(v, fast_config, fast_config)
        s, m, g, imu = diag_real.drive(v, vcfg, 11, n_scans=3)
        real.append(diag_real.diagnose(v, vcfg, s, m, g, "cpu", "cpu",
                                       warmup=1, imu=imu))
    ms = profile_engine2.run(cfg, scans[:3], valids[:3], "cpu", "cpu",
                             warm=1)
    ate, loops, kf = diag_tiny.run(diag_tiny.config(fast_config), scans[:3],
                                   valids[:3], gt[:3], "cpu", "cpu")
    out = capsys.readouterr().out
    res = diag_loops.replay(cfg, scans, valids, gt, "cpu", label="seed 3")
    lines = capsys.readouterr().out.splitlines()
    rows = debug_fig8.run(cfg, scans[:3], valids[:3], gt[:3], "cpu", "cpu")
    out += capsys.readouterr().out
    assert [v["name"] for v in variants] == ["base", "exact"]
    assert variants[0]["ate"] == variants[1]["ate"]      # the same config
    assert all(_finite(*v["fps"], *v["ate"]) for v in variants)
    assert "the port's kNN is exact" in out
    # odo maps the first scan only (its interval is 1e9 s).
    assert real[0]["kf"] == 1 and real[1]["kf"] >= 1
    assert all(_finite(r["fps"], r["ate"], r["rot"].max(), r["trans"].max())
               for r in real)
    assert "=== ordered:" in out and "worst scans" in out
    assert len(ms) == 4 and _finite(*ms) and "C + loop every tick" in out
    assert _finite(ate) and kf >= 1 and loops == 0
    # A loop tick every mapping tick, a mapping tick every 3rd scan.
    assert len(res["records"]) == len(lines) - 1 - len(res["factors"]) == 2
    assert [r["scan"] for r in res["records"]] == [0, 3]
    assert res["est"].shape == (SCANS, 4, 4) and _finite(res["ate"])
    assert lines[-1 - len(res["factors"])].startswith("seed 3: ate=")
    assert [r["frame"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["err"]).all() for r in rows)


def test_fit_recovers_the_three_terms():
    """``profile_iters.fit`` on rows made from known terms."""
    rows = [dict(it=it, researches=profile_iters.researches(it, re),
                 device_ms=1.5 + 0.25 * it
                 + 0.75 * profile_iters.researches(it, re))
            for it, re in profile_iters.ODO_GRID]
    f = profile_iters.fit(rows, "device_ms")
    assert f == pytest.approx(dict(fixed=1.5, per_iteration=0.25,
                                   per_research=0.75))
    assert profile_iters.researches(8, 3) == 3      # 0, 3, 6
    assert profile_iters.researches(1, 1) == 1
    assert profile_iters.fit(rows[:1], "device_ms") is None


def test_tools_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("with a card the default device runs")
    for tool in TOOLS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])
