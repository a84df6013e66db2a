"""The port's bench (``sc_lego_loam_tpu_torch/tools/bench.py``) against the
JAX package's ``bench.py`` on the CPU, at the tiny size: its metrics on the
same inputs, the worker fan-out of ``utils/synthetic.make_sequence`` (bit
for bit against the serial cast and the JAX package's generator), the
sequence cache, the fragments of the six blocks (keys exactly
``bench.py``'s), and the tools' refusal to run on the CPU unasked."""

import types

import numpy as np
import pytest
import torch

import bench as jbench
from sc_lego_loam_tpu.config import tiny_test_config as jax_tiny
from sc_lego_loam_tpu.utils import synthetic as jsynthetic
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.tools import bench, profile_stages, run_capacity
from sc_lego_loam_tpu_torch.utils import evaluate, synthetic

torch.set_num_threads(1)

RNG = np.random.default_rng(7)


def _clover_gt(n=520):
    """The bench's cloverleaf poses (3 revisit events at 10 Hz)."""
    return synthetic.cloverleaf_trajectory(n, radius=32.0,
                                           petals=4).astype(np.float32)


def _loops(gt):
    """Four accepted factors over keyframes 0.3 s apart: three true (two
    on the centre's pass at scan 261, one at scan 390), one 5 m off."""
    kf_scans = np.arange(0, len(gt), 3)
    pairs = [(87, 0), (88, 1), (130, 1), (100, 13)]
    z = []
    for n, (i, j) in enumerate(pairs):
        zi = np.linalg.inv(gt[kf_scans[i]]) @ gt[kf_scans[j]]
        zi[:3, 3] += RNG.normal(0, 0.05, 3) + (5.0 if n == 3 else 0.0)
        z.append(zi)
    L = 8
    li = np.zeros(L, np.int32)
    lj = np.zeros(L, np.int32)
    lz = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    li[:4], lj[:4] = [p[0] for p in pairs], [p[1] for p in pairs]
    lz[:4] = np.asarray(z, np.float32)
    return (kf_scans * 0.1).astype(np.float32), li, lj, lz, 4


def _engines(gt, est):
    """One fake engine for each bench: numpy leaves and ``engine.map`` for
    ``bench.py``, tensors and ``engine.m`` for the port."""
    times, li, lj, lz, n = _loops(gt)
    jeng = types.SimpleNamespace(
        loops=types.SimpleNamespace(i=li, j=lj, z=lz, count=np.int32(n)),
        map=types.SimpleNamespace(kf=types.SimpleNamespace(times=times)),
        trajectory_array=lambda: est)
    teng = types.SimpleNamespace(
        loops=types.SimpleNamespace(
            i=torch.from_numpy(li), j=torch.from_numpy(lj),
            z=torch.from_numpy(lz), count=torch.tensor(n, dtype=torch.int32)),
        m=types.SimpleNamespace(kf=types.SimpleNamespace(
            times=torch.from_numpy(times))),
        trajectory_array=lambda: est)
    return jeng, teng


def test_metrics_equal_bench_py():
    gt = _clover_gt()
    est = gt.copy()
    est[:, :3, 3] += RNG.normal(0, 0.1, (len(gt), 3)).astype(np.float32)
    jcfg, tcfg = jax_tiny(), tiny_test_config()
    jeng, teng = _engines(gt, est)

    jrev, jn = jbench.revisit_mask(gt, jeng, jcfg)
    trev, tn = evaluate.revisit_mask(gt, tcfg.loop.rs_search_radius)
    np.testing.assert_array_equal(trev, jrev)
    assert tn == jn == 3

    jpr = jbench.loop_precision_recall(jeng, gt, jcfg)
    tpr = bench.loop_pr(teng, gt, tcfg)
    assert tpr == jpr
    assert (tpr["accepted"], tpr["true_factors"]) == (4, 3)
    assert tpr["precision"] == 0.75 and tpr["recall"] == 0.667

    ja, tb = jbench.ates(jeng, gt, 16), bench.ates(teng, gt, 16)
    np.testing.assert_allclose(tb, ja, rtol=0, atol=1e-4)
    assert tb[0] != tb[1]


def test_make_sequence_workers_equal_serial_and_jax():
    cfg, jcfg = tiny_test_config(), jax_tiny()
    for kw in (dict(trajectory="figure8", radius=30.0, loops=1.05),
               dict(trajectory="figure8", radius=30.0, loops=1.05,
                    shuffle=False, skew=True)):
        two = synthetic.make_sequence(cfg.lidar, 3, seed=11, workers=2, **kw)
        one = synthetic.make_sequence(cfg.lidar, 3, seed=11, **kw)
        ref = jsynthetic.make_sequence(jcfg.lidar, 3, seed=11, **kw)
        for a, b, c in zip(two, one, ref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_get_sequence_caches_once(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    made = []
    real = synthetic.make_sequence

    def counted(*a, **kw):
        made.append(kw.pop("workers"))
        return real(*a, **kw)

    monkeypatch.setattr(synthetic, "make_sequence", counted)
    lidar = tiny_test_config().lidar
    kw = dict(trajectory="straight", step=0.4, noise=0.01, seed=3,
              shuffle=False)
    first = bench.get_sequence(lidar, 2, **kw)
    second = bench.get_sequence(lidar, 2, **kw)
    files = list(tmp_path.iterdir())
    assert len(made) == 1 and made[0] >= 1
    assert len(files) == 1 and files[0].suffix == ".npz"
    for a, b, c in zip(first, second, real(lidar, 2, **kw)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# Scans of the stubbed drives: more than bench.py's warm-up of 16, which its
# steady ATE skips.
STUB_SCANS = 24


def _keys(frag):
    """The key tree of a fragment (dict keys, recursively)."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in frag.items()}


def _stub_jax_bench(monkeypatch, n):
    """``bench.py``'s blocks with its engine, data and JAX setup stubbed,
    so that its fragments show their keys without a JAX drive."""
    gt = synthetic.straight_trajectory(n).astype(np.float32)
    jeng, _ = _engines(_clover_gt(), gt)
    jeng.loops_closed = np.int32(1)
    jeng.map.kf.count = np.int32(3)
    jeng.timer = types.SimpleNamespace(table=lambda skip_first: "")
    zeros = np.zeros((n, 4, 3), np.float32)

    def run_engine(cfg, scans, valids, warmup, imu=None, latency=None):
        if latency is not None:
            latency += [10.0, 20.0]
        return jeng, 1.0

    monkeypatch.setattr(jbench, "_setup_jax", lambda: types.SimpleNamespace(
        default_backend=lambda: "cpu"))
    monkeypatch.setattr(jbench, "get_sequence",
                        lambda lidar, m, **kw: (zeros, zeros[..., 0] > 0, gt))
    monkeypatch.setattr(jbench, "run_engine", run_engine)
    return {name: fn() for name, fn in jbench.BLOCKS.items()}


def test_one_block_on_the_cpu_gives_bench_py_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    frag = bench.block_ordered("cpu", tiny_test_config(), n_scans=8,
                               warmup=2, seeds=[11])
    want = _stub_jax_bench(monkeypatch, STUB_SCANS)["ordered"]
    assert _keys(frag) == _keys(want)
    assert frag["platform"] == "cpu" and frag["ordered"]["scans"] == 6
    o = frag["ordered"]
    assert np.isfinite(o["ate_rmse_m"]) and o["keyframes"] >= 1
    assert frag["seed_sweep"]["ate"] == [o["ate_rmse_m"]]


def test_every_block_gives_bench_py_keys(monkeypatch):
    n = STUB_SCANS
    want = _stub_jax_bench(monkeypatch, n)
    gt = synthetic.straight_trajectory(n).astype(np.float32)
    _, teng = _engines(_clover_gt(), gt)
    teng.loops_closed = torch.tensor(1, dtype=torch.int32)
    teng.m.kf.count = torch.tensor(3, dtype=torch.int32)
    teng.trace = types.SimpleNamespace(table=lambda skip_first: "")
    zeros = np.zeros((n, 4, 3), np.float32)
    fed = []

    def run_engine(cfg, scans, valids, warmup, imu=None, latency=None,
                   device="cuda"):
        fed.append((cfg.imu.enabled, imu is not None, device))
        if latency is not None:
            latency += [10.0, 20.0]
        return teng, 1.0

    monkeypatch.setattr(bench, "get_sequence",
                        lambda lidar, m, **kw: (zeros, zeros[..., 0] > 0, gt))
    monkeypatch.setattr(bench, "run_engine", run_engine)
    cfg = tiny_test_config()
    for name, fn in bench.BLOCKS.items():
        frag = fn("cpu", cfg, n_scans=n, warmup=2)
        assert _keys(frag) == _keys(want[name]), name
    assert all(d == "cpu" for _, _, d in fed)
    assert (True, True, "cpu") in fed          # real_imu feeds its stream
    assert sum(on for on, _, _ in fed) == 1
    assert bench.block_names() == list(jbench.BLOCKS)


def test_tools_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("with a card the default device runs")
    for tool in (bench, profile_stages, run_capacity):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])
