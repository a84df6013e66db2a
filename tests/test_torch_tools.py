"""The port's two command-line entry points on the CPU, at the tiny size:
``tools/run_synthetic`` (drive, verdict, PLY / TUM / NPZ export) and
``tools/run_mulran`` (a generated MulRan-layout directory, the JSON line).
Each is called through its ``main(argv)``, as ``python -m`` calls it."""

import json
import os

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch import runner
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.tools import run_mulran, run_synthetic
from sc_lego_loam_tpu_torch.utils import export, synthetic

torch.set_num_threads(1)

N_SCANS = 6


def _exports(prefix):
    return [prefix + tail for tail in ("_map.ply", "_traj.txt", "_ckpt.npz")]


def test_run_synthetic_drives_and_exports(tmp_path, capsys):
    prefix = str(tmp_path / "run")
    rc = run_synthetic.main(["--device", "cpu", "--scans", str(N_SCANS),
                             "--export", prefix])
    out = capsys.readouterr().out
    assert rc == 0 and "VERDICT: PASS" in out
    assert f"scan {N_SCANS - 1:3d}:" in out and "perception" in out
    ply, tum, ckpt = _exports(prefix)
    with open(ply) as f:
        assert f.readline() == "ply\n"
    rows = np.loadtxt(tum)
    assert rows.shape == (N_SCANS, 8)
    np.testing.assert_allclose(rows[:, 0], 0.1 * np.arange(N_SCANS), atol=1e-6)
    # The checkpoint resumes into a fresh engine of the same configuration.
    engine = export.load_checkpoint(
        ckpt, SlamEngine(tiny_test_config(), device="cpu"))
    assert engine.trajectory_array().shape == (N_SCANS, 4, 4)
    np.testing.assert_allclose(engine.trajectory_array()[:, :3, 3],
                               rows[:, 1:4], atol=1e-5)


def test_run_synthetic_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("with a card the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_synthetic.main(["--scans", "1"])


def test_run_mulran_prints_its_json_line(tmp_path, capsys, monkeypatch):
    cfg = tiny_test_config()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_SCANS, trajectory="straight", step=0.4, noise=0.01,
        seed=5)
    root = tmp_path / "seq"
    folder = root / "sensor_data" / "Ouster"
    os.makedirs(folder)
    rows = []
    for i in range(N_SCANS):
        ts = 1_566_535_000_000_000_000 + i * 100_000_000
        pts = scans[i][valids[i]]
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)],
                       1).tofile(str(folder / f"{ts}.bin"))
        rows.append([ts] + list(gt[i][:3, :4].reshape(-1)))
    np.savetxt(str(root / "global_pose.csv"), np.asarray(rows, np.float64),
               delimiter=",")
    # The tool runs the OS1-64 configuration; the fixture is the tiny sensor.
    monkeypatch.setattr(runner, "mulran_engine_config", lambda: cfg)
    prefix = str(tmp_path / "out")
    rc = run_mulran.main(["--root", str(root), "--device", "cpu", "--no-loop",
                          "--scans", str(N_SCANS - 1), "--progress", "2",
                          "--export", prefix])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert sum(line.startswith("scan ") for line in lines) == 2
    res = json.loads(lines[-1])
    assert res["sequence"] == str(root) and res["device"] == "cpu"
    assert res["scans"] == N_SCANS - 1 and res["loops_closed"] == 0
    assert res["loader"] in ("native", "python")
    assert res["ate_rmse_m"] < 0.8 and res["keyframes"] >= 1
    assert res["gt_length_m"] == pytest.approx(0.4 * (N_SCANS - 2), abs=0.1)
    assert all(os.path.getsize(p) > 0 for p in _exports(prefix))
