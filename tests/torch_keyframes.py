"""Hand-made keyframe stores for the batch and merge tests of the port
(tests/test_torch_batch_loop.py, tests/test_torch_merge.py,
tests/test_torch_loop_graph.py, tests/test_torch_batch_graph.py,
tests/test_torch_trace.py): keyframe
clouds cast from the synthetic world at true poses, stored at estimated
poses, with their Scan Context descriptors, as numpy dicts in the field
layout of ``mapping.KeyframeStore`` / ``scan_context.DescriptorBank``
(either package's)."""

import contextlib
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import torch

from sc_lego_loam_tpu.models import scan_context as jsc
from sc_lego_loam_tpu.utils import se3 as jse3, synthetic


# Iteration caps of the JAX package's unrolled ICP and GN loops in these
# tests: its compile time grows with them (the batched loop tick compiles
# in 114 s at the defaults 15 / 20 and in 42 s at 8 / 6 on one CPU thread),
# and both packages run to the same cap.
ICP_ITERATIONS = 8
GN_ITERATIONS = 6


def fewer_iterations(cfg):
    return cfg.replace(
        loop=dataclasses.replace(cfg.loop,
                                 icp_max_iterations=ICP_ITERATIONS),
        posegraph=dataclasses.replace(cfg.posegraph,
                                      max_gn_iterations=GN_ITERATIONS))


def short_loop(cfg):
    """Fewer ICP and GN iterations than ``fewer_iterations``' and
    half the ICP's pads (the CPU's brute-force kNN over query x target
    pads is what these tests spend their time on); the closing state still
    closes, its re-solve converged before the cap."""
    return cfg.replace(
        cap=dataclasses.replace(cfg.cap, icp_query_pad=1024,
                                history_pad=4096),
        loop=dataclasses.replace(cfg.loop, icp_max_iterations=4),
        posegraph=dataclasses.replace(cfg.posegraph, max_gn_iterations=5))


def loop_cfg(base):
    """Small detector ranges and the relaxed graph weights of
    tests/test_torch_loop.py (so that a re-solve moves the poses)."""
    cfg = fewer_iterations(base())
    return cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=3),
        loop=dataclasses.replace(cfg.loop, rs_time_gap=4.0,
                                 rs_search_radius=4.0, loop_noise_var=1e-2,
                                 history_num=2),
        posegraph=dataclasses.replace(cfg.posegraph, odom_var=(1e-2,) * 6))


def circle(n, radius=4.0, center=(0.0, 0.0)):
    """n poses round a circle, the last where the first is, at 2 m."""
    ang = np.linspace(0.0, 2 * np.pi, n)
    gt = np.stack([np.eye(4, dtype=np.float32)] * n)
    gt[:, 0, 3] = center[0] + radius * np.cos(ang)
    gt[:, 1, 3] = center[1] + radius * np.sin(ang)
    gt[:, 2, 3] = 2.0
    return gt


def twist(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))


def sequence(cfg, world, gt, est, times, rng):
    """One sequence's keyframe store and descriptor bank: clouds (all
    returns, as surf features) cast at ``gt``, poses stored as ``est``."""
    K, cap = cfg.cap.max_keyframes, cfg.cap
    n = len(gt)
    eye = np.eye(4, dtype=np.float32)
    kf = dict(poses6=np.zeros((K, 6), np.float32),
              times=np.zeros(K, np.float32),
              corner=np.zeros((K, cap.kf_corner_pad, 3), np.float32),
              corner_mask=np.zeros((K, cap.kf_corner_pad), bool),
              surf=np.zeros((K, cap.kf_surf_pad, 3), np.float32),
              surf_mask=np.zeros((K, cap.kf_surf_pad), bool),
              outlier=np.zeros((K, cap.kf_outlier_pad, 3), np.float32),
              outlier_mask=np.zeros((K, cap.kf_outlier_pad), bool),
              odom_z=np.stack([eye] * K), odom_pose=np.stack([eye] * K),
              count=np.int32(n))
    desc = np.zeros((K, cfg.sc.num_ring, cfg.sc.num_sector), np.float32)
    kf["poses6"][:n] = np.asarray(jse3.mat_to_pose6(jnp.asarray(est)))
    kf["times"][:n] = times
    for k in range(n):
        pts, valid = synthetic.raycast(world, gt[k], cfg.lidar, noise=0.01,
                                       rng=rng)
        keep = pts[valid][:cap.kf_surf_pad]
        kf["surf"][k, :len(keep)] = keep
        kf["surf_mask"][k, :len(keep)] = True
        kf["odom_z"][k] = est[k] if k == 0 else \
            np.linalg.inv(est[k - 1]) @ est[k]
        kf["odom_pose"][k] = est[k]
        desc[k] = np.asarray(jsc.make_descriptor(
            jnp.asarray(pts), jnp.asarray(valid), cfg.sc))
    bank = dict(desc=desc, ringkey=desc.mean(-1), count=np.int32(n))
    return kf, bank


def loop_state(cfg, outcome):
    """A single-sequence mapper state as numpy, in the JAX field layout.
    Closed and rejected: eight keyframes round a 4 m circle, the last where
    the first stood with its stored pose drifted (tests/
    test_torch_batch_loop.py's sequence 0); no candidate: three keyframes
    0.1 s apart."""
    world = synthetic.default_world(seed=3)
    rng = np.random.default_rng(4)
    if outcome == "no candidate":
        gt = np.stack([np.eye(4, dtype=np.float32)] * 3)
        gt[:, 0, 3], gt[:, 2, 3] = [20.0, 20.4, 20.8], 2.0
        est, times = gt, np.float32([0, 0.1, 0.2])
    else:
        gt = circle(8)
        est = gt.copy()
        est[-1] = est[-1] @ twist([0, 0, 0.02, 0.15, -0.1, 0])
        times = np.arange(8, dtype=np.float32)
    kf, bank = sequence(cfg, world, gt, est, times, rng)
    L = cfg.posegraph.max_loops
    eye = np.eye(4, dtype=np.float32)
    return types.SimpleNamespace(
        kf=types.SimpleNamespace(**kf), bank=types.SimpleNamespace(**bank),
        loops=types.SimpleNamespace(
            i=np.zeros(L, np.int32), j=np.zeros(L, np.int32),
            z=np.broadcast_to(eye, (L, 4, 4)).copy(), count=np.int32(0)),
        correction=eye, pose=est[-1], last_kf_pose=est[-1],
        last_kf_odom=est[-1].copy(), loops_closed=np.int32(0),
        kf_dropped=np.int32(0))


def loop_tick_cfg(base, outcome):
    """``short_loop(loop_cfg(base))`` for ``loop_state``'s states; for
    "rejected", with a fitness gate nothing passes."""
    cfg = short_loop(loop_cfg(base))
    if outcome == "rejected":
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop,
                                                   fitness_threshold=-1.0))
    return cfg


READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__",
         "__float__", "__index__")


@contextlib.contextmanager
def no_host_reads():
    """Every way of reading a tensor's value on the host raises."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read inside the gated tick")

    for name in READS:
        setattr(torch.Tensor, name, refuse)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
