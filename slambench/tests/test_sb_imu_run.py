"""(b) A whole run on the CPU of a tiny cell whose configuration has the
IMU on: it comes out ``correct``, every scan is preceded by one push of
its samples, the engine's IMU ring holds them after the warm-up, and the
published poses differ from the same drive's with the IMU off."""

from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from slambench import run, session
from sb_tiny import add_cell, copy_tree

SEED = 2 ** 31 + 17
STREAM = {"rate_hz": 100.0, "noise_rpy": 0.003, "noise_acc": 0.05,
          "noise_gyro": 0.003}


def test_imu_cell_runs_and_uses_its_samples(tmp_path, monkeypatch):
    dst = str(tmp_path)
    copy_tree(dst)
    seen = {"pushes": 0, "published": [], "ring": []}
    push, published, warm_up = (SlamEngine.push_imu_batch,
                                session.Run.published, session.Run.warm_up)

    def counted(self, *args):
        seen["pushes"] += 1
        return push(self, *args)

    def kept(self):
        seen["published"].append(published(self))
        return seen["published"][-1]

    def warmed(self, n):
        warm_up(self, n)
        seen["ring"].append(int(self.system.engine.p.imu.count))

    monkeypatch.setattr(SlamEngine, "push_imu_batch", counted)
    monkeypatch.setattr(session.Run, "published", kept)
    monkeypatch.setattr(session.Run, "warm_up", warmed)

    cell = add_cell(dst, "tinyimu", imu_stream=STREAM)
    out = run.run_cell(cell, SEED, 3600.0, False, "cpu")
    assert out["correct"], out["checks"]
    scans = out["attempted"] + cell.config["warmup_scans"]
    assert scans == cell.config["drive_scans"]
    assert seen["pushes"] == scans
    assert seen["ring"][0] > 1

    plain = add_cell(dst, "tinyplain")
    out = run.run_cell(plain, SEED, 3600.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert seen["pushes"] == scans and seen["ring"][1] == 0
    with_imu, without = seen["published"]
    assert with_imu.shape == without.shape
    assert abs(with_imu - without).max() > 1e-4
