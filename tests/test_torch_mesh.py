"""The port's mesh layer (``parallel/mesh.py``) and its two sharded
functions against the JAX package's on the conftest's 8-device mesh:
``parallel.retrieval.detect_sharded`` on the bank of
tests/test_parallel.py, and ``posegraph.solve(..., mesh=)`` on its graph.
The port's side runs in 2 and in 4 gloo processes
(``tools/dryrun_multichip.run_ranks``, rank functions in
tests/torch_mesh_ranks.py); the JAX references are computed here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sc_lego_loam_tpu import posegraph as jpg
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.models import scan_context as jsc
from sc_lego_loam_tpu.parallel import mesh as jmesh, retrieval as jret
from sc_lego_loam_tpu.utils import se3 as jse3
from sc_lego_loam_tpu_torch import posegraph as tpg
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.tools.dryrun_multichip import run_ranks

from torch_mesh_ranks import solve_cfg

torch.set_num_threads(1)

TESTS = __import__("os").path.dirname(__import__("os").path.abspath(__file__))
WORLDS = (2, 4)


def _inputs():
    """tests/test_parallel.py's retrieval bank and drifty 24-node chain
    with one loop factor, as numpy."""
    cfg = solve_cfg(tiny_test_config)
    rng = np.random.default_rng(0)
    K = cfg.cap.max_keyframes
    bank = jsc.init_bank(cfg)
    descs = []
    for _ in range(60):
        d = jnp.asarray(rng.random((cfg.sc.num_ring, cfg.sc.num_sector)),
                        jnp.float32)
        descs.append(d)
        bank = jsc.append(bank, d, K)

    rng = np.random.default_rng(1)
    n = 24
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        step = np.eye(4, dtype=np.float32)
        step[0, 3] = 1.0
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    odom_z = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    odom_z[0] = gt[0]
    est = [gt[0]]
    for i in range(1, n):
        Z = np.linalg.inv(gt[i - 1]) @ gt[i]
        noise = np.asarray(jse3.se3_exp(jnp.asarray(
            rng.normal(0, 0.01, 6), jnp.float32)))
        Z = (Z @ noise).astype(np.float32)
        odom_z[i] = Z
        est.append((est[-1] @ Z).astype(np.float32))
    poses6 = np.zeros((K, 6), np.float32)
    poses6[:n] = np.asarray(jse3.mat_to_pose6(jnp.asarray(np.stack(est))))
    loops = jpg.add_loop(jpg.init_loops(cfg), jnp.int32(n - 1), jnp.int32(0),
                         jnp.asarray(np.linalg.inv(gt[n - 1]) @ gt[0],
                                     jnp.float32))
    return cfg, dict(
        desc=np.asarray(bank.desc), count=np.asarray(bank.count),
        query=np.asarray(descs[4]), poses6=poses6, n=np.int32(n),
        odom_z=odom_z, **{"loop_" + f: np.asarray(getattr(loops, f))
                          for f in ("i", "j", "z", "count")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, inp = _inputs()
    mesh8 = jmesh.make_mesh(n_kf=4, n_seq=2)
    ref = jret.detect_sharded(
        cfg, mesh8, jax.device_put(jnp.asarray(inp["desc"]),
                                   NamedSharding(mesh8, P("kf"))),
        jnp.asarray(inp["count"]), jnp.asarray(inp["query"]))
    shard_l = NamedSharding(mesh8, P("kf"))
    loops = jpg.LoopFactors(
        i=jax.device_put(jnp.asarray(inp["loop_i"]), shard_l),
        j=jax.device_put(jnp.asarray(inp["loop_j"]), shard_l),
        z=jax.device_put(jnp.asarray(inp["loop_z"]),
                         NamedSharding(mesh8, P("kf", None, None))),
        count=jnp.asarray(inp["loop_count"]))
    solved = jpg.solve(cfg, jnp.asarray(inp["poses6"]), jnp.int32(inp["n"]),
                       jnp.asarray(inp["odom_z"]), loops, mesh=mesh8)
    unsharded = tpg.solve(
        solve_cfg(tiny_torch), torch.from_numpy(inp["poses6"]), torch.tensor(inp["n"]),
        torch.from_numpy(inp["odom_z"]),
        tpg.LoopFactors(*(torch.from_numpy(inp["loop_" + f].copy())
                          for f in ("i", "j", "z", "count"))))
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "in.npz", **inp)
    out = {}
    for n in WORLDS:
        path = str(d / f"out{n}.npz")
        run_ranks(n, "torch_mesh_ranks:mesh_rank",
                  dict(inp=str(d / "in.npz"), out=path), path=[TESTS],
                  device="cpu",
                  timeout=300)
        out[n] = (dict(np.load(path)),
                  dict(np.load(path + ".collectives.npz")))
    return inp, (ref, np.asarray(solved), unsharded.numpy()), out


def test_mesh_collectives(runs):
    """make_mesh's axes, gather_rows (one and several banks, bool and
    int32 ones too), owner_write at the first and the last slot,
    exchange, gather_full, take_block, share, bring and agree, each held
    to what one process computes from the whole bank (the checks run in
    the ranks: a failed one fails the launch)."""
    *_, out = runs
    for n in WORLDS:
        assert bool(out[n][1]["ok"]) and int(out[n][1]["calls"]) > 0


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_retrieval_matches_jax(runs, n):
    """The same idx as the JAX package's detect_sharded on its 8-device
    mesh (2 x 4: the bank split over 4 'kf' shards), dist within 1e-5 and yaw within 1e-6."""
    _, ((idx, dist, yaw), _, _), out = runs
    got = out[n][0]
    assert int(got["idx"]) == int(idx) >= 0
    np.testing.assert_allclose(float(got["dist"]), float(dist), atol=1e-5)
    np.testing.assert_allclose(float(got["yaw"]), float(yaw), atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_solve_matches_jax_and_unsharded(runs, n):
    """Against the JAX package's solve(mesh=mesh8) at tests/test_parallel.py's
    5e-3 (both at ``solve_cfg``'s 4 GN iterations), and bit-equal to the
    port's unsharded solve: every rank holds the first rank's solution."""
    inp, (_, solved_j, unsharded), out = runs
    k = int(inp["n"])
    got = out[n][0]["solved"]
    np.testing.assert_allclose(got[:k], solved_j[:k], atol=5e-3)
    np.testing.assert_array_equal(got, unsharded)
