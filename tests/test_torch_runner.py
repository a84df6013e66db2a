"""The port's MulRan runner (``runner.py``, ``utils/mulran.py``,
``utils/native_io.py``) on generated MulRan-format fixtures, against the
JAX package's: the loaders decode the same bytes to the same arrays, and
``run_mulran(..., device="cpu")`` runs end to end through the Python and
the native loader."""

import os
import struct

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import runner as jrunner
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.utils import mulran as jmulran, synthetic
from sc_lego_loam_tpu_torch import runner as trunner
from sc_lego_loam_tpu_torch.utils import mulran as tmulran, native_io

torch.set_num_threads(1)

N_SCANS = 12
T0_NS = 1_566_535_000_000_000_000        # MulRan-era epoch ns


@pytest.fixture(scope="module")
def mulran_fixture(tmp_path_factory):
    """A straight synthetic drive in the MulRan raw layout (only real
    returns in the .bin files, 10 Hz epoch timestamps)."""
    root = tmp_path_factory.mktemp("mulran_seq")
    cfg = tiny_test_config()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_SCANS, trajectory="straight", step=0.4, noise=0.01,
        seed=5)
    d = root / "sensor_data" / "Ouster"
    os.makedirs(d)
    rows = []
    for i in range(N_SCANS):
        ts = T0_NS + i * 100_000_000
        pts = scans[i][valids[i]]
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)],
                       1).astype(np.float32).tofile(str(d / f"{ts}.bin"))
        rows.append([ts] + list(gt[i][:3, :4].reshape(-1)))
    np.savetxt(str(root / "global_pose.csv"), np.asarray(rows, np.float64),
               delimiter=",")
    return str(root), cfg, scans, valids, gt


@pytest.fixture(scope="module")
def port_runs(mulran_fixture):
    """The port's runner over the fixture, once per loader."""
    root, cfg = mulran_fixture[:2]
    return {native: trunner.run_mulran(root, config=cfg, use_native=native,
                                       loop_enabled=False, device="cpu")
            for native in (False, True)}


def test_loader_roundtrip(mulran_fixture):
    root, cfg, scans, valids, _ = mulran_fixture
    files = tmulran.scan_files(root)
    assert files == jmulran.scan_files(root) and len(files) == N_SCANS
    assert tmulran.available(root) and not tmulran.available(root + "/none")
    pts, mask = tmulran.load_scan(files[0], cfg.lidar)
    pts_j, mask_j = jmulran.load_scan(files[0], cfg.lidar)
    np.testing.assert_array_equal(pts, pts_j)
    np.testing.assert_array_equal(mask, mask_j)
    assert pts.shape == (cfg.lidar.max_points, 3)
    want = scans[0][valids[0]]
    np.testing.assert_allclose(pts[mask], want[:int(mask.sum())], atol=1e-6)
    ts = [t for t, _, _ in tmulran.iter_scans(root, cfg.lidar, limit=3)]
    np.testing.assert_allclose(ts, [(T0_NS + i * 10 ** 8) * 1e-9
                                    for i in range(3)])


def test_gt_loader(mulran_fixture):
    root, _, _, _, gt = mulran_fixture
    ts, poses = tmulran.load_gt_poses(root)
    ts_j, poses_j = jmulran.load_gt_poses(root)
    np.testing.assert_array_equal(ts, ts_j)
    np.testing.assert_array_equal(poses, poses_j)
    assert poses.shape == (N_SCANS, 4, 4)
    np.testing.assert_allclose(poses[3], gt[3], atol=1e-5)
    # Nearest ground-truth pose per scan time; none without the csv.
    picked = trunner.gt_at_times(root, ts[[0, 5]] + 0.04)
    np.testing.assert_array_equal(picked, poses[[0, 5]])
    assert trunner.gt_at_times(root + "/sensor_data", ts) is None


def test_golden_bytes_hand_written(tmp_path):
    """Bit-exact parser fixture: the .bin / global_pose.csv bytes are
    HAND-BUILT with struct.pack and literal text, pinning endianness and
    field order (little-endian float32 x,y,z,intensity; timestamp_ns, then
    the 3x4 [R|t] row-major), for the Python and the native loader."""
    root = tmp_path / "seq"
    d = root / "sensor_data" / "Ouster"
    os.makedirs(d)
    ts_ns = 1566535200123456789
    pts = [(1.5, -2.25, 0.5, 7.0),
           (10.0, 0.0, -1.0, 0.0),
           (0.0, 0.0, 0.0, 3.0)]   # zero return -> must be masked out
    with open(d / f"{ts_ns}.bin", "wb") as f:
        f.write(b"".join(struct.pack("<ffff", *p) for p in pts))
    with open(root / "global_pose.csv", "w") as f:
        f.write(f"{ts_ns},0,-1,0,100,1,0,0,-50,0,0,1,3\n")
        f.write(f"{ts_ns + 100000000},1,0,0,101,0,1,0,-50,0,0,1,3\n")

    cfg = tiny_test_config()
    files = tmulran.scan_files(str(root))
    assert files == [str(d / f"{ts_ns}.bin")]
    out, mask = tmulran.load_scan(files[0], cfg.lidar)
    np.testing.assert_array_equal(out[0], np.float32([1.5, -2.25, 0.5]))
    np.testing.assert_array_equal(out[1], np.float32([10.0, 0.0, -1.0]))
    assert mask[0] and mask[1]
    assert not mask[2]            # zero return masked
    assert not mask[3:].any()     # padding masked

    ts, poses = tmulran.load_gt_poses(str(root))
    np.testing.assert_allclose(ts[0], ts_ns * 1e-9, rtol=0, atol=1e-6)
    want = np.array([[0, -1, 0, 100],
                     [1, 0, 0, -50],
                     [0, 0, 1, 3],
                     [0, 0, 0, 1]], np.float32)
    np.testing.assert_array_equal(poses[0], want)

    assert native_io.available(), native_io.why_unavailable()
    with native_io.NativeScanLoader(files, cfg.lidar.max_points) as loader:
        pts_n, mask_n = next(loader)
        with pytest.raises(StopIteration):
            next(loader)
    np.testing.assert_array_equal(pts_n[:3], out[:3])
    np.testing.assert_array_equal(mask_n, mask)


def test_native_library_is_built_into_the_ports_build_directory():
    assert native_io.available(), native_io.why_unavailable()
    built = [f for f in os.listdir(native_io.BUILD_DIR)
             if f.startswith("libscloam_io_")]
    assert built
    assert os.path.basename(native_io.BUILD_DIR) == "_build"
    assert "sc_lego_loam_tpu_torch" in native_io.BUILD_DIR
    assert os.path.basename(os.path.dirname(native_io.SOURCE)) == "native"


def test_native_loader_matches_python_loader(mulran_fixture):
    root, cfg = mulran_fixture[:2]
    files = tmulran.scan_files(root)
    with native_io.NativeScanLoader(files, cfg.lidar.max_points,
                                    n_threads=3) as loader:
        served = list(loader)
    assert len(served) == N_SCANS            # in file order, then the end
    for f, (pts_n, mask_n) in zip(files, served):
        pts_p, mask_p = tmulran.load_scan(f, cfg.lidar)
        np.testing.assert_array_equal(mask_n, mask_p)
        np.testing.assert_array_equal(pts_n[mask_n], pts_p[mask_p])


def test_native_writers(tmp_path):
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    pcd, ply = str(tmp_path / "m.pcd"), str(tmp_path / "m.ply")
    native_io.write_pcd(pcd, pts)
    native_io.write_ply(ply, pts)
    with open(pcd, "rb") as f:
        hdr, body = f.read().split(b"DATA binary\n")
    assert b"POINTS 10" in hdr
    np.testing.assert_array_equal(
        np.frombuffer(body, np.float32).reshape(10, 3), pts)
    with open(ply, "rb") as f:
        hdr, body = f.read().split(b"end_header\n")
    assert b"element vertex 10" in hdr
    np.testing.assert_array_equal(
        np.frombuffer(body, np.float32).reshape(10, 3), pts)
    with pytest.raises(IOError):
        native_io.write_ply(str(tmp_path / "no_such_dir" / "m.ply"), pts)


@pytest.mark.parametrize("native", [False, True])
def test_run_mulran_end_to_end(port_runs, mulran_fixture, native):
    res = port_runs[native]
    assert res["loader"] == ("native" if native else "python")
    assert res["scans"] == N_SCANS and res["sequence"] == mulran_fixture[0]
    assert res["est"].shape == (N_SCANS, 4, 4)
    assert np.isfinite(res["est"]).all() and np.isfinite(res["fps"])
    assert res["keyframes"] >= 2 and res["loops_closed"] == 0
    assert res["ate_rmse_m"] < 0.8, res["ate_rmse_m"]
    assert res["gt_length_m"] == pytest.approx(0.4 * (N_SCANS - 1), abs=0.01)
    # Sequence-relative float32 time, not the epoch's (which float32
    # cannot tell apart).
    np.testing.assert_allclose(res["times"], 0.1 * np.arange(N_SCANS),
                               atol=1e-6)
    assert res["engine"].device.type == "cpu"
    assert not res["engine"].config.loop.enabled


def test_both_loaders_give_the_same_trajectory(port_runs):
    """The same bytes through either loader: the same run, bit for bit."""
    np.testing.assert_array_equal(port_runs[False]["est"],
                                  port_runs[True]["est"])


def test_run_mulran_matches_the_jax_runner(port_runs, mulran_fixture):
    """The JAX package's runner over the same directory: same scans, times
    and keyframes, an ATE in the same band, trajectories inside the spread
    of the 10-scan straight drive (tests/test_torch_slice.py: 0.2 m)."""
    root, cfg = mulran_fixture[:2]
    rj = jrunner.run_mulran(root, config=cfg, use_native=False,
                            loop_enabled=False)
    rt = port_runs[False]
    assert rt["scans"] == rj["scans"] and rt["keyframes"] == rj["keyframes"]
    np.testing.assert_allclose(rt["times"], rj["times"], atol=1e-7)
    assert abs(rt["gt_length_m"] - rj["gt_length_m"]) < 1e-4
    assert abs(rt["ate_rmse_m"] - rj["ate_rmse_m"]) < 0.1
    d = np.linalg.norm(rt["est"][:, :3, 3] - rj["est"][:, :3, 3], axis=1)
    assert d.max() < 0.2, d


def test_run_mulran_refuses_a_directory_without_scans(tmp_path):
    with pytest.raises(FileNotFoundError, match="sensor_data/Ouster"):
        trunner.run_mulran(str(tmp_path), device="cpu")


def test_run_stream_shorter_than_its_warmup(mulran_fixture):
    """Fewer scans than the warm-up: no rate, the trajectory all the same."""
    _, cfg, scans, valids, _ = mulran_fixture
    engine = trunner.SlamEngine(cfg, device="cpu")
    res = trunner.run_stream(
        engine, ((0.1 * i, scans[i], valids[i]) for i in range(2)))
    assert res["scans"] == 2 and np.isnan(res["fps"])
    assert res["est"].shape == (2, 4, 4)
