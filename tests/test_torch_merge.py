"""The port's cross-sequence merge (``parallel/batch.py``:
``find_cross_loops``, ``verify_cross_loops``, ``anchor_sequence``,
``merge_solve``) and the multi-chain ``posegraph.solve`` (``node_mask``,
``free_edges``) against the JAX package's on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import posegraph as jpg
from sc_lego_loam_tpu.config import (LoopClosureConfig, PoseGraphConfig,
                                     tiny_test_config)
from sc_lego_loam_tpu.mapping import KeyframeStore as JKeyframes
from sc_lego_loam_tpu.models import scan_context as jsc
from sc_lego_loam_tpu.parallel import batch as jb
from sc_lego_loam_tpu.utils import se3 as jse3, synthetic
from sc_lego_loam_tpu_torch import mapping as tmapping, posegraph as tpg
from sc_lego_loam_tpu_torch.config import (
    LoopClosureConfig as TLoopClosureConfig,
    PoseGraphConfig as TPoseGraphConfig, tiny_test_config as tiny_torch)
from sc_lego_loam_tpu_torch.models import scan_context as tsc
from sc_lego_loam_tpu_torch.parallel import batch as tb

from torch_keyframes import (GN_ITERATIONS, circle, fewer_iterations,
                             sequence, twist)

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def test_find_cross_loops_matches_jax():
    """tests/test_batch.py::test_find_cross_loops_same_world's banks (B
    holds A's scenes yaw-rotated): every output equal, pair for pair."""
    cfg = tiny_test_config()
    rng = np.random.default_rng(0)
    K = cfg.cap.max_keyframes
    ja, jb_ = jsc.init_bank(cfg), jsc.init_bank(cfg)
    for _ in range(6):
        d = jnp.asarray(rng.random((cfg.sc.num_ring, cfg.sc.num_sector)),
                        jnp.float32)
        ja = jsc.append(ja, d, K)
        jb_ = jsc.append(jb_, jnp.roll(d, 10, axis=1), K)
    want = [np.asarray(x) for x in jb.find_cross_loops(cfg, ja, jb_)]
    ta = tsc.DescriptorBank(*(T(x) for x in ja))
    tb_ = tsc.DescriptorBank(*(T(x) for x in jb_))
    got = [x.numpy() for x in tb.find_cross_loops(tiny_torch(), ta, tb_)]
    assert [g.shape for g in got] == [w.shape for w in want] == [(8,)] * 5
    np.testing.assert_array_equal(got[4], want[4])               # ok
    ok = want[4]
    assert int(ok.sum()) >= 4
    # The accepted pairs are exact matches at distance ~1e-7, whose order
    # is the last bits of the sums: the same pairs, yaws and distances.
    pairs = [sorted(zip(x[0][ok], x[1][ok], np.round(x[3][ok], 6)))
             for x in (got, want)]
    assert pairs[0] == pairs[1]
    np.testing.assert_allclose(np.sort(got[2][ok]), np.sort(want[2][ok]),
                               atol=1e-6)
    # The rest in index order (a stable sort of 1e9 entries), as in JAX.
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[~ok], w[~ok])


def test_anchor_sequence_matches_jax():
    rng = np.random.default_rng(1)
    K = 12
    poses6_b = rng.normal(0, 1, (K, 6)).astype(np.float32)
    pose6_a = rng.normal(0, 1, 6).astype(np.float32)
    Z = twist(rng.normal(0, 0.3, 6))
    want = np.asarray(jb.anchor_sequence(
        jnp.asarray(poses6_b), jnp.int32(9), jnp.asarray(pose6_a),
        jnp.asarray(Z), jnp.int32(4)))
    got = tb.anchor_sequence(T(poses6_b), torch.tensor(9), T(pose6_a), T(Z),
                             torch.tensor(4)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(got[9:], poses6_b[9:])   # past the count


def _chains():
    """tests/test_batch.py::test_merge_solve_joins_sequences: two drifty
    copies of one straight chain, the second placed 5 m off, tied by four
    identity cross factors in global ids."""
    cfg = tiny_test_config().replace(
        posegraph=PoseGraphConfig(odom_var=(1e-2,) * 6, max_loops=16,
                                  max_gn_iterations=GN_ITERATIONS),
        loop=LoopClosureConfig(loop_noise_var=1e-4))
    tcfg = tiny_torch().replace(
        posegraph=TPoseGraphConfig(odom_var=(1e-2,) * 6, max_loops=16,
                                   max_gn_iterations=GN_ITERATIONS),
        loop=TLoopClosureConfig(loop_noise_var=1e-4))
    K, n = cfg.cap.max_keyframes, 12
    gt = np.stack([np.eye(4, dtype=np.float32)] * n)
    gt[:, 0, 3] = np.arange(n)

    def make_chain(offset_y, drift_seed):
        r = np.random.default_rng(drift_seed)
        odom = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
        start = np.eye(4, dtype=np.float32)
        start[1, 3] = offset_y
        odom[0] = start
        est = [start]
        for i in range(1, n):
            Z = (np.linalg.inv(gt[i - 1]) @ gt[i]
                 @ twist(r.normal(0, 0.01, 6))).astype(np.float32)
            odom[i] = Z
            est.append((est[-1] @ Z).astype(np.float32))
        poses6 = np.zeros((K, 6), np.float32)
        poses6[:n] = np.asarray(jse3.mat_to_pose6(jnp.asarray(np.stack(est))))
        return poses6, odom

    p0, o0 = make_chain(0.0, 10)
    p1, o1 = make_chain(5.0, 11)
    loops = jpg.init_loops(cfg)
    for k in (1, 4, 7, 10):
        loops = jpg.add_loop(loops, jnp.int32(K + k), jnp.int32(k),
                             jnp.eye(4, dtype=jnp.float32))
    loops = [np.asarray(x) for x in loops]
    return cfg, tcfg, np.stack([p0, p1]), np.stack([o0, o1]), \
        np.int32([n, n]), loops, n


@pytest.fixture(scope="module")
def merged():
    """The JAX package's ``merge_solve`` of the two chains (one jit
    compile, shared by the tests below)."""
    cfg, tcfg, poses6, odom, counts, loops, n = _chains()
    want = np.asarray(jb.merge_solve(
        cfg, jnp.asarray(poses6), jnp.asarray(counts), jnp.asarray(odom),
        jpg.LoopFactors(*(jnp.asarray(x) for x in loops))))
    return tcfg, poses6, odom, counts, loops, n, want


def test_merge_solve_matches_jax(merged):
    """The joint solve of the two chains: within 2e-3 of the JAX package's
    result (fp32 GN with the backtracking line search, both sides), and
    with the JAX test's own outcome (sequence 1 pulled onto the route)."""
    tcfg, poses6, odom, counts, loops, n, want = merged
    got = tb.merge_solve(tcfg, T(poses6), T(counts), T(odom),
                         tpg.LoopFactors(*(T(x) for x in loops))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.abs(got[0, :n, 3:6] - poses6[0, :n, 3:6]).max() < 0.5
    assert np.abs(got[1, :n, 4]).max() < 1.0
    np.testing.assert_array_equal(got[:, n:], poses6[:, n:])


def test_multi_chain_solve_matches_jax(merged):
    """``posegraph.solve`` itself on the concatenated chains, with the node
    mask and the seam as a free edge (what the JAX ``merge_solve`` hands
    its ``solve``), against the JAX result; 2e-3 as above.  Without the
    free edge the seam is a stiff odometry factor and the solve cannot
    move sequence 1 as a whole."""
    tcfg, poses6, odom, counts, loops, n, want = merged
    K = poses6.shape[1]
    flat = poses6.reshape(2 * K, 6)
    odom_flat = odom.reshape(2 * K, 4, 4).copy()
    X = np.asarray(jse3.pose6_to_mat(jnp.asarray(flat)))
    odom_flat[K] = np.linalg.inv(X[K - 1]) @ X[K]
    mask = (np.arange(K)[None] < counts[:, None]).reshape(-1)
    lf = tpg.LoopFactors(*(T(x) for x in loops))
    got = tpg.solve(tcfg, T(flat), torch.tensor(2 * K), T(odom_flat), lf,
                    node_mask=T(mask), free_edges=torch.tensor([K])).numpy()
    np.testing.assert_allclose(got.reshape(2, K, 6), want, atol=2e-3)
    np.testing.assert_array_equal(got[~mask], flat[~mask])
    stiff = tpg.solve(tcfg, T(flat), torch.tensor(2 * K), T(odom_flat), lf,
                      node_mask=T(mask)).numpy()
    assert np.abs(stiff[K:K + n, 4]).max() > 2.0


def test_verify_cross_loops_on_shared_keyframes():
    """Two sequences over one 4 m circle (B the other way round), B's poses
    stored in a frame 3 m and 0.4 rad off A's: the candidates of ``find_cross_loops``, then
    ``verify_cross_loops`` in both packages from the same stores.  The
    same verdicts; fitness to 1e-3 m^2 and Z to 5e-3 (the loop-closure
    tolerance of tests/test_torch_loop.py)."""
    cfg = fewer_iterations(tiny_test_config())
    world = synthetic.default_world(seed=3)
    rng = np.random.default_rng(8)
    gt = circle(8)[:7]
    off = twist([0, 0, 0.4, 3.0, -1.0, 0.0])
    times = np.arange(7, dtype=np.float32)
    kf_a, bank_a = sequence(cfg, world, gt, gt, times, rng)
    kf_b, bank_b = sequence(cfg, world, gt[::-1].copy(),
                            off[None] @ gt[::-1], times, rng)
    jbank = [jsc.DescriptorBank(**{k: jnp.asarray(v) for k, v in b.items()})
             for b in (bank_a, bank_b)]
    ia, ib, _, yaw, ok = jb.find_cross_loops(cfg, *jbank, max_pairs=4)
    assert bool(np.asarray(ok).all())
    jkf = [JKeyframes(**{k: jnp.asarray(v) for k, v in s.items()})
           for s in (kf_a, kf_b)]
    Zj, fj, aj = (np.asarray(x) for x in jb.verify_cross_loops(
        cfg, *jkf, ia, ib, yaw, ok))
    tkf = [tmapping.KeyframeStore(**{k: T(v) for k, v in s.items()})
           for s in (kf_a, kf_b)]
    Zt, ft, at = tb.verify_cross_loops(
        fewer_iterations(tiny_torch()), *tkf, T(ia), T(ib), T(yaw), T(ok))
    np.testing.assert_array_equal(at.numpy(), aj)
    assert aj.sum() >= 2
    np.testing.assert_allclose(ft.numpy(), fj, atol=1e-3)
    np.testing.assert_allclose(Zt.numpy(), Zj, atol=5e-3)
    # An accepted factor measures the true relative pose of the two
    # keyframes in one frame (about the identity: the same place).
    gt_b = gt[::-1]
    for p in np.flatnonzero(aj):
        truth = np.linalg.inv(gt[int(ia[p])]) @ gt_b[int(ib[p])]
        assert np.abs(Zt.numpy()[p] - truth).max() < 0.05
