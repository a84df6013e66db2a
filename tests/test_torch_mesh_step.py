"""One ``mapping_step`` and one ``loop_step`` of the sharded port engine
against the JAX package's sharded engine, from one shared state: eight
hand-made keyframes round a 4 m circle, the last standing where the first
stood with its stored pose drifted (tests/torch_keyframes.py), and one
scan cast there.  The JAX steps run on its banks sharded over the
conftest's 8 devices (``pipeline._shard_mapper_state``, as
``SlamEngine(cfg, mesh=Mesh(devs[:8], ("kf",)))`` holds them); the port's
in 2 gloo processes, the state carried in by ``convert.mapper_state(...,
mesh)``, each rank taking its rows.  Tolerances are the single-step
tests': 0.05 m / 0.5 deg for the mapped pose (tests/test_torch_slice.py),
5e-3 for loop closure (tests/test_torch_loop.py); and the sharded port
steps equal the unsharded port steps bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sc_lego_loam_tpu import pipeline as jp
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch import pipeline as tp
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.tools.dryrun_multichip import run_ranks
from sc_lego_loam_tpu_torch.utils import convert, export

from torch_keyframes import circle, sequence, twist
from torch_mesh_ranks import nest, step_cfg

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))


def _rot_deg(a, b):
    R = a[:3, :3].T @ b[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def _shared_state(cfg_j, cfg_t):
    """The mapper state (flat numpy, dotted keys) and the mapping step's
    ten inputs: the port's perception of one scan at the circle's end from
    a fresh odometry state (identity odometry pose), with the correction
    set to the drifted last keyframe pose."""
    world = synthetic.default_world(seed=3)
    rng = np.random.default_rng(4)
    gt = circle(8)
    est = gt.copy()
    est[-1] = est[-1] @ twist([0, 0, 0.02, 0.15, -0.1, 0])
    kf, bank = sequence(cfg_j, world, gt, est, np.arange(8, dtype=np.float32),
                        rng)
    L = cfg_j.posegraph.max_loops
    eye = np.eye(4, dtype=np.float32)
    flat = {"m.kf." + k: v for k, v in kf.items()}
    flat.update({"m.bank." + k: v for k, v in bank.items()})
    flat.update({"m.loops.i": np.zeros(L, np.int32),
                 "m.loops.j": np.zeros(L, np.int32),
                 "m.loops.z": np.stack([eye] * L),
                 "m.loops.count": np.int32(0),
                 "m.correction": est[-1], "m.pose": est[-1],
                 "m.last_kf_pose": est[-1], "m.last_kf_odom": est[-1],
                 "m.loops_closed": np.int32(0), "m.kf_dropped": np.int32(0)})
    pts, valid = synthetic.raycast(world, gt[-1], cfg_j.lidar, noise=0.01,
                                   rng=rng)
    t = torch.full((), 8.0)
    p = tp.init_perception_state(cfg_t, "cpu")
    p, odom, out_pts, out_mask, _ = tp.perception_step(
        cfg_t, p, torch.eye(4), torch.from_numpy(pts),
        torch.from_numpy(valid), t)
    ins = (p.odo.corner_last.xyz, p.odo.corner_last.mask, p.odo.surf_last.xyz,
           p.odo.surf_last.mask, out_pts, out_mask, odom,
           torch.from_numpy(pts), torch.from_numpy(valid), t)
    flat.update({"in.%d" % k: x.numpy() for k, x in enumerate(ins)})
    return flat


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    cfg_j, cfg_t = step_cfg(tiny_test_config), step_cfg(tiny_torch)
    flat = _shared_state(cfg_j, cfg_t)
    d = tmp_path_factory.mktemp("mesh_step")
    np.savez(d / "in.npz", **flat)

    def jax_and_unsharded():
        mesh = Mesh(np.asarray(jax.devices()[:8]), ("kf",))
        m_np = nest(flat, "m.")

        def sharded_state():
            mst = jp.MapperState(
                kf=jp.mapping.KeyframeStore(**{
                    k: jnp.asarray(v) for k, v in vars(m_np.kf).items()}),
                bank=jp.scan_context.DescriptorBank(**{
                    k: jnp.asarray(v) for k, v in vars(m_np.bank).items()}),
                loops=jp.posegraph.LoopFactors(**{
                    k: jnp.asarray(v) for k, v in vars(m_np.loops).items()}),
                **{k: jnp.asarray(getattr(m_np, k))
                   for k in ("correction", "pose", "last_kf_pose",
                             "last_kf_odom", "loops_closed", "kf_dropped")})
            return jp._shard_mapper_state(mst, mesh)

        args = [jnp.asarray(flat["in.%d" % k]) for k in range(10)]
        imu = jp.init_perception_state(cfg_j).imu
        mj = jax.tree.map(np.asarray, jp.mapping_step(
            cfg_j, sharded_state(), *args, imu))
        lj = jax.tree.map(np.asarray, jp.loop_step(cfg_j, sharded_state()))
        targs = [torch.from_numpy(flat["in.%d" % k].copy())
                 for k in range(10)]
        mt = tp.mapping_step(cfg_t, convert.mapper_state(m_np, "cpu"), *targs)
        lt = tp.loop_step(cfg_t, convert.mapper_state(m_np, "cpu"))
        return (mj, lj), (mt, lt)

    jax_out, port_out = run_ranks(
        2, "torch_mesh_ranks:step_rank",
        dict(inp=str(d / "in.npz"), out=str(d / "out.npz")), path=[TESTS],
        device="cpu",
        background=jax_and_unsharded, timeout=600)
    return jax_out, port_out, dict(np.load(d / "out.npz"))


def test_sharded_steps_equal_unsharded_port(steps):
    _, (mt, lt), got = steps
    for tag, st in (("map", mt), ("loop", lt)):
        for path, leaf in export.state_leaves(st):
            np.testing.assert_array_equal(got[f"{tag}.{path}"], leaf.numpy(),
                                          err_msg=f"{tag}.{path}")


def test_mapping_step_matches_jax_mesh_engine(steps):
    (mj, _), _, got = steps
    pose_t, pose_j = got["map.pose"], np.asarray(mj.pose)
    assert np.linalg.norm(pose_t[:3, 3] - pose_j[:3, 3]) < 0.05
    assert _rot_deg(pose_t, pose_j) < 0.5
    n = int(mj.kf.count)
    assert int(got["map.kf.count"]) == n and int(got["map.bank.count"]) == \
        int(mj.bank.count)
    np.testing.assert_array_equal(got["map.kf.surf_mask"][:n],
                                  mj.kf.surf_mask[:n])
    np.testing.assert_allclose(got["map.bank.desc"][:n], mj.bank.desc[:n],
                               atol=1e-5)


def test_loop_step_matches_jax_mesh_engine(steps):
    """The tick closes in both: the same factor (i, j, count; Z to 5e-3),
    the same re-solved poses, pose and correction to 5e-3."""
    (_, lj), _, got = steps
    assert int(got["loop.loops_closed"]) == int(lj.loops_closed) == 1
    for f in ("i", "j", "count"):
        np.testing.assert_array_equal(got["loop.loops." + f],
                                      getattr(lj.loops, f))
    np.testing.assert_allclose(got["loop.loops.z"], lj.loops.z, atol=5e-3)
    np.testing.assert_allclose(got["loop.kf.poses6"][:8], lj.kf.poses6[:8],
                               atol=5e-3)
    for name in ("correction", "pose", "last_kf_pose"):
        np.testing.assert_allclose(got["loop." + name], getattr(lj, name),
                                   atol=5e-3)
