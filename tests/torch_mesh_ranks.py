"""Rank functions of the port's mesh tests (tests/test_torch_mesh.py,
test_torch_engine_mesh.py, test_torch_mesh_step.py,
test_torch_batch_mesh.py).  Each runs in a process that
``sc_lego_loam_tpu_torch.tools.dryrun_multichip.run_ranks`` started: one
CPU thread, a gloo group joined through a ``FileStore``.  It reads its
inputs from an NPZ the test wrote and rank 0 writes what the test checks.
This module imports neither jax nor a test module: a rank process has
neither."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from sc_lego_loam_tpu_torch import pipeline as tp, posegraph
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.parallel import batch, mesh as mesh_mod, retrieval
from sc_lego_loam_tpu_torch.utils import convert, export, se3

ENGINE_SCANS = 12


def engine_cfg():
    """Loop ticks on every mapping tick, and a radius search that finds a
    keyframe >= 1 s older within 6 m: the 12-scan straight drive closes a
    loop at scan 10 (a 4.8 m span, its ICP accepts)."""
    cfg = tiny_test_config()
    return cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=3),
        loop=dataclasses.replace(cfg.loop, check_every_ticks=1,
                                 rs_time_gap=1.0, rs_search_radius=6.0))


def step_cfg(base):
    """tests/torch_keyframes.py's ``loop_cfg`` (small detector ranges,
    relaxed graph weights, the capped ICP and GN iterations), for either
    package's ``tiny_test_config``."""
    cfg = base()
    return cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=3),
        loop=dataclasses.replace(cfg.loop, rs_time_gap=4.0,
                                 rs_search_radius=4.0, loop_noise_var=1e-2,
                                 history_num=2, icp_max_iterations=8),
        posegraph=dataclasses.replace(cfg.posegraph, odom_var=(1e-2,) * 6,
                                      max_gn_iterations=6))


def solve_cfg(base):
    """``tiny_test_config`` with 4 GN iterations: tests/test_parallel.py's
    graph converges in fewer (its solution equals the 20-iteration one
    bit for bit), and the JAX package's compile time grows with them
    (85 s at 20, 27 s at 4 on the 8-device CPU mesh)."""
    cfg = base()
    return cfg.replace(posegraph=dataclasses.replace(
        cfg.posegraph, max_gn_iterations=4))


def nest(flat: dict, prefix: str):
    """A namespace tree of the arrays under ``prefix`` (dotted keys)."""
    root = types.SimpleNamespace()
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = root
        *path, leaf = key[len(prefix):].split(".")
        for name in path:
            if not hasattr(node, name):
                setattr(node, name, types.SimpleNamespace())
            node = getattr(node, name)
        setattr(node, leaf, value)
    return root


def _barrier(shard):
    mesh_mod.all_reduce_sum(torch.zeros(1), shard)


def collectives_rank(info, out):
    """``gather_rows`` (one and several banks), ``owner_write``,
    ``exchange``, ``gather_full``, ``share``, ``bring`` and ``agree``
    against what one process computes from the whole bank."""
    n = info["world"]
    mesh = mesh_mod.make_mesh(n, 1, device_type="cpu")
    assert mesh.mesh_dim_names == ("seq", "kf")
    assert tuple(mesh.shape) == (1, n)
    shard = mesh_mod.bank_sharding(mesh)
    assert shard.size == n and shard.index == info["rank"]
    assert mesh_mod.init_distributed() == n       # joined already: no-op
    K = 4 * n
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.normal(size=(K, 5, 3)).astype(np.float32))
    full_m = torch.from_numpy(rng.random((K, 5)) > 0.5)
    full_i = torch.from_numpy(rng.integers(0, 99, (K, 2)).astype(np.int32))
    lo, rows = shard.block(K)
    local = [x[lo:lo + rows].clone() for x in (full, full_m, full_i)]
    idx = torch.tensor([K - 1, 0, 2, 2, rows])
    got = mesh_mod.gather_rows(tuple(local), idx, mesh)
    for g, f in zip(got, (full, full_m, full_i)):
        assert g.dtype == f.dtype and torch.equal(g, f[idx])
    assert torch.equal(mesh_mod.gather_rows(local[0], idx, mesh), full[idx])
    assert torch.equal(mesh_mod.gather_rows(full, idx, mesh_mod.replicated()),
                       full[idx])
    row = torch.full((5, 3), 7.0)
    for slot in (0, K - 1):
        mesh_mod.owner_write(local[0], torch.tensor([slot]), row, mesh)
        full[slot] = row
        assert torch.equal(mesh_mod.gather_full(local[0], mesh), full)
    assert torch.equal(mesh_mod.gather_full(local[1], mesh), full_m)
    ex = mesh_mod.exchange(torch.tensor([float(info["rank"]), 1.0]), mesh)
    assert ex.tolist() == [[float(r), 1.0] for r in range(n)]
    mine = torch.full((2,), float(info["rank"]))
    shared, flag = mesh_mod.share((mine, torch.tensor(info["rank"] == 0)),
                                  mesh)
    assert shared.tolist() == [0.0, 0.0] and bool(flag)
    brought = mesh_mod.bring(torch.full((3,), float(info["rank"])), n - 1,
                             shard)
    assert brought.tolist() == [float(n - 1)] * 3
    assert mesh_mod.agree(torch.tensor([True, False]), mesh) == [True, False]
    try:
        mesh_mod.agree(torch.tensor(info["rank"] == 0), mesh)
    except RuntimeError as e:
        assert "disagree" in str(e)
    else:
        raise AssertionError("agree() let ranks that disagree through")
    if info["rank"] == 0:
        np.savez(out, ok=True, calls=mesh_mod.stats["calls"])


def retrieval_solve_rank(info, inp, out):
    """``retrieval.detect_sharded`` and ``posegraph.solve(mesh=)`` on the
    inputs of tests/test_parallel.py."""
    n = info["world"]
    mesh = mesh_mod.make_mesh(n, 1, device_type="cpu")
    cfg = solve_cfg(tiny_test_config)
    z = dict(np.load(inp))
    lo, rows = mesh_mod.bank_sharding(mesh).block(z["desc"].shape[0])
    idx, dist, yaw = retrieval.detect_sharded(
        cfg, mesh, torch.from_numpy(z["desc"][lo:lo + rows]),
        torch.tensor(z["count"]), torch.from_numpy(z["query"]))
    loops = posegraph.LoopFactors(
        *(torch.from_numpy(z["loop_" + f]) for f in ("i", "j", "z", "count")))
    solved = posegraph.solve(cfg, torch.from_numpy(z["poses6"]),
                             torch.tensor(z["n"]), torch.from_numpy(z["odom_z"]),
                             loops, mesh=mesh)
    if info["rank"] == 0:
        np.savez(out, idx=int(idx), dist=float(dist), yaw=float(yaw),
                 solved=solved.numpy(), calls=mesh_mod.stats["calls"])


def engine_rank(info, inp, out, ckpt):
    """The sharded engine over the drive, its NPZ checkpoint, and the
    checkpoint loaded back into a fresh sharded engine."""
    mesh = mesh_mod.make_mesh(info["world"], 1, device_type="cpu")
    cfg = engine_cfg()
    z = np.load(inp)
    eng = tp.SlamEngine(cfg, device="cpu", mesh=mesh)
    for i in range(ENGINE_SCANS):
        eng.process_scan(z["scans"][i], z["valids"][i], t=i * 0.1)
    traj = eng.trajectory_array()
    raw = eng.trajectory_array(retro_correct=False)
    arrays = export.checkpoint_arrays(eng)
    calls, nbytes = mesh_mod.stats["calls"], mesh_mod.stats["bytes"]
    export.save_checkpoint(ckpt, eng)
    _barrier(eng.shard)
    fresh = tp.SlamEngine(cfg, device="cpu", mesh=mesh)
    export.load_checkpoint(ckpt, fresh)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        export.state_leaves(eng.m), export.state_leaves(fresh.m))) and \
        fresh.m.kf.corner.shape[0] == cfg.cap.max_keyframes // info["world"]
    if info["rank"] == 0:
        np.savez(out, traj=traj, raw=raw, loops_closed=int(eng.loops_closed),
                 map_ticks=eng.map_ticks, loop_ticks=eng.loop_ticks,
                 loaded_back_equal=same, calls=calls, bytes=nbytes,
                 **{"ck." + k: v for k, v in arrays.items()})


def step_rank(info, inp, out):
    """One ``mapping_step`` and one ``loop_step``, each from the shared
    state, on banks sharded over the ranks."""
    mesh = mesh_mod.make_mesh(info["world"], 1, device_type="cpu")
    shard = mesh_mod.bank_sharding(mesh)
    cfg = step_cfg(tiny_test_config)
    z = dict(np.load(inp))
    args = [torch.from_numpy(z["in.%d" % k]) for k in range(10)]
    mst = convert.mapper_state(nest(z, "m."), "cpu", mesh)
    mt = tp.mapping_step(cfg, mst, *args, mesh=shard)
    lt = tp.loop_step(cfg, convert.mapper_state(nest(z, "m."), "cpu", mesh),
                      mesh=shard)
    res = {}
    for tag, st in (("map", mt), ("loop", lt)):
        for path, leaf in export.state_leaves(st):
            if path in tp.SHARDED_LEAVES:
                leaf = mesh_mod.gather_full(leaf, shard)
            res[f"{tag}.{path}"] = leaf.numpy()
    if info["rank"] == 0:
        np.savez(out, **res)


def batch_rank(info, inp, out):
    """``BatchEngine(n_seq=2)`` with one sequence a rank over the steps,
    then ``merge_solve`` of the two chains, each brought to every rank."""
    mesh = mesh_mod.make_mesh(1, info["world"], device_type="cpu")
    z = np.load(inp)
    cfg = tiny_test_config()
    eng = batch.BatchEngine(cfg, n_seq=2, mesh=mesh, device="cpu")
    assert eng.n_local == 2 // info["world"]
    for t in range(z["points"].shape[0]):
        eng.process_scans(z["points"][t], z["masks"][t], t=t * 0.1)
    traj = eng.trajectory_array()
    banks = [eng.sequence_banks(s) for s in (0, 1)]
    merged = merge_pair(cfg, banks)
    if info["rank"] == 0:
        res = dict(traj=traj, merged=merged.numpy())
        for s, (kf, bank) in enumerate(banks):
            res.update({f"{s}.kf.{k}": v.numpy()
                        for k, v in kf._asdict().items()})
            res.update({f"{s}.bank.{k}": v.numpy()
                        for k, v in bank._asdict().items()})
        np.savez(out, **res)


def merge_pair(cfg, banks):
    """``merge_solve`` of two sequences' chains joined at their first
    keyframes by one cross factor (their relative pose as stored)."""
    (kf0, _), (kf1, _) = banks
    K = cfg.cap.max_keyframes
    X0 = se3.pose6_to_mat(kf0.poses6[:1])[0]
    X1 = se3.pose6_to_mat(kf1.poses6[:1])[0]
    xloops = posegraph.add_loop(posegraph.init_loops(cfg, "cpu"), K, 0,
                                se3.mat_inv(X1) @ X0)
    return batch.merge_solve(
        cfg, torch.stack([kf0.poses6, kf1.poses6]),
        torch.stack([kf0.count, kf1.count]),
        torch.stack([kf0.odom_z, kf1.odom_z]), xloops)


def mesh_rank(info, inp, out):
    """tests/test_torch_mesh.py's ranks: the collectives, then sharded
    retrieval and the sharded solve."""
    collectives_rank(info, out + ".collectives.npz")
    retrieval_solve_rank(info, inp, out)
