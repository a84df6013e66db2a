"""The port's diagnostics (``sc_lego_loam_tpu_torch/tools/``) against the
JAX package's tools on the same numpy inputs, on the CPU:

- ``diag_loops.tick_record`` against the JAX calls of the root
  ``tools/diag_loops.py:60-95`` on one hand-made keyframe store
  (tests/torch_keyframes.py) carried into both packages through
  ``utils/convert``: candidates exactly, SC distance and yaw, ICP fitness
  and inlier ratio within the loop tests' ICP spread, the accept flags
  exactly;
- ``diag_real.rel_errors`` and the rotation-scale ratio against the root
  ``tools/diag_real.py`` (imported by path: it imports jax only inside
  ``main``), to float64 rounding;
- ``profile_micro.desc_bcast`` and ``thin_group`` against the root
  ``tools/profile_micro.py``'s own functions (taken from its source);
- ``debug_fig8.twist_errors``' first frames against the JAX odometry at
  tests/test_torch_odometry.py's 2e-4."""

import ast
import dataclasses
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu_torch import mapping as tmapping
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.models import scan_context as tsc
from sc_lego_loam_tpu_torch.tools import (debug_fig8, diag_loops, diag_real,
                                          profile_micro)
from sc_lego_loam_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
# tests/test_torch_loop.py: loop closure from one shared state agrees to
# 5e-3 m; the ICP's mean-square fitness (m^2) and inlier ratio move by
# far less than that on this store.
ICP_TOL = 2e-3
SC_TOL = 1e-5


def _root_module(name):
    spec = importlib.util.spec_from_file_location(
        f"root_tool_{name}", os.path.join(ROOT_TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_nested(name, functions, namespace):
    """The functions ``functions`` defined inside ``main`` of the root tool
    ``name``, compiled from its source into ``namespace``."""
    with open(os.path.join(ROOT_TOOLS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body
            if isinstance(n, ast.FunctionDef) and n.name in functions]
    assert {d.name for d in defs} == set(functions)
    exec(compile(ast.Module(body=defs, type_ignores=[]), name, "exec"),
         namespace)
    return [namespace[f] for f in functions]


# ---------------------------------------------------------------- diag_loops

def _closing_store(cfg):
    """Eight keyframes round a 4 m circle, the last where the first stood
    with its stored pose drifted (tests/test_torch_loop_graph.py's closing
    state), as numpy in the JAX field layout."""
    from sc_lego_loam_tpu.utils import synthetic
    from torch_keyframes import circle, sequence, twist

    rng = np.random.default_rng(4)
    gt = circle(8)
    est = gt.copy()
    est[-1] = est[-1] @ twist([0, 0, 0.02, 0.15, -0.1, 0])
    kf, bank = sequence(cfg, synthetic.default_world(seed=3), gt, est,
                        np.arange(8, dtype=np.float32), rng)
    return types.SimpleNamespace(**kf), types.SimpleNamespace(**bank)


def _jax_record(cfg, kf_np, bank_np):
    """The root tool's per-tick calls (tools/diag_loops.py:60-95) on the
    JAX package."""
    from sc_lego_loam_tpu import loop as loop_mod, mapping as jmapping
    from sc_lego_loam_tpu.models import scan_context
    from sc_lego_loam_tpu.ops import icp
    from sc_lego_loam_tpu.utils import se3

    kf = jmapping.KeyframeStore(**{f: jnp.asarray(getattr(kf_np, f))
                                   for f in jmapping.KeyframeStore._fields})
    bank = scan_context.DescriptorBank(
        **{f: jnp.asarray(getattr(bank_np, f))
           for f in scan_context.DescriptorBank._fields})
    cur = max(int(kf.count) - 1, 0)
    sc_idx, sc_dist, sc_yaw = scan_context.detect(cfg, bank, bank.desc[cur])
    rs_idx = loop_mod.detect_radius(cfg, kf, jnp.int32(cur))
    si, ri = int(sc_idx), int(rs_idx)
    rec = dict(kf=cur, sc_idx=si, sc_dist=float(sc_dist),
               sc_yaw=float(sc_yaw), rs_idx=ri, sc=None, rs=None)

    def verify(idx, place, T0=None):
        src, srcm = loop_mod.keyframe_cloud(cfg, kf, jnp.int32(cur), place)
        dst, dstm = loop_mod.history_submap(cfg, kf, jnp.int32(idx))
        _, fit, inl = icp.align(cfg, src, srcm, dst, dstm, T0=T0)
        ok = (float(fit) < cfg.loop.fitness_threshold and
              float(inl) >= cfg.loop.min_inlier_ratio)
        return dict(idx=idx, fitness=float(fit), inlier_ratio=float(inl),
                    accept=ok)

    if si >= 0:
        place = se3.pose6_to_mat(kf.poses6[si])
        Rz = se3.rt_to_mat(
            se3.euler_zyx_to_mat(-sc_yaw, jnp.float32(0), jnp.float32(0)),
            jnp.zeros(3))
        rec["sc"] = verify(si, place, place @ Rz @ se3.mat_inv(place))
    if ri >= 0 and ri != si:
        rec["rs"] = verify(ri, se3.pose6_to_mat(kf.poses6[cur]))
    return rec


def _diag_cfg(base, detector):
    """The keyframe tests' loop configuration (short ICP); ``"rs"`` shuts
    the Scan Context detector so the radius search's branch runs."""
    from torch_keyframes import loop_cfg, short_loop

    cfg = short_loop(loop_cfg(base))
    if detector == "rs":
        cfg = cfg.replace(sc=dataclasses.replace(cfg.sc, dist_threshold=-1.0))
    return cfg


@pytest.mark.parametrize("detector", ["sc", "rs"])
def test_tick_record_matches_jax(detector):
    """One loop tick's record: the SC candidate (its ICP seeded with the
    SC yaw) or, with SC shut, the radius-search candidate."""
    kf_np, bank_np = _closing_store(_diag_cfg(tiny_test_config, detector))
    want = _jax_record(_diag_cfg(tiny_test_config, detector), kf_np, bank_np)
    engine = types.SimpleNamespace(m=types.SimpleNamespace(
        kf=convert.to_torch(tmapping.KeyframeStore, kf_np, "cpu"),
        bank=convert.to_torch(tsc.DescriptorBank, bank_np, "cpu")))
    got = diag_loops.tick_record(_diag_cfg(tiny_torch, detector), engine)
    assert got["kf"] == want["kf"] == 7
    assert got["sc_idx"] == want["sc_idx"] and got["rs_idx"] == want["rs_idx"]
    assert abs(got["sc_dist"] - want["sc_dist"]) < SC_TOL
    assert abs(got["sc_yaw"] - want["sc_yaw"]) < SC_TOL
    other = "rs" if detector == "sc" else "sc"
    assert got[other] is None and want[other] is None
    g, w = got[detector], want[detector]
    assert g is not None and w is not None
    assert g["idx"] == w["idx"] and g["accept"] == w["accept"]
    assert abs(g["fitness"] - w["fitness"]) < ICP_TOL
    assert abs(g["inlier_ratio"] - w["inlier_ratio"]) < ICP_TOL
    assert g["accept"]               # the closing store closes
    line = diag_loops.format_record(10, got, _diag_cfg(tiny_torch, detector))
    assert line.startswith("scan   10 kf   7:") and "accept=True" in line


# ----------------------------------------------------------------- diag_real

def _trajectories(n=40, seed=2):
    """A turning ground truth and an estimate off it by small random
    twists per scan."""
    from torch_keyframes import twist

    rng = np.random.default_rng(seed)
    gt, est = [np.eye(4)], [np.eye(4)]
    for _ in range(1, n):
        step = twist([0, 0, rng.uniform(0.0, 0.05), 0.7, 0.0, 0.0])
        gt.append(gt[-1] @ step)
        est.append(est[-1] @ step @ twist(rng.normal(0, 3e-3, 6)))
    return np.stack(est), np.stack(gt)


def _root_ratios(est, gt, w):
    """The root tool's twist-scale diagnostic (tools/diag_real.py:91-102)."""
    n = min(len(est), len(gt))
    ratios = []
    for i in range(w, n):
        ze = np.linalg.inv(est[i - 1]) @ est[i]
        zg = np.linalg.inv(gt[i - 1]) @ gt[i]
        ae = np.degrees(np.arccos(np.clip(
            (np.trace(ze[:3, :3]) - 1) / 2, -1, 1)))
        ag = np.degrees(np.arccos(np.clip(
            (np.trace(zg[:3, :3]) - 1) / 2, -1, 1)))
        if ag > 0.5:
            ratios.append(ae / ag)
    return np.asarray(ratios)


def test_rel_errors_and_rotation_scale_match_root():
    root = _root_module("diag_real")
    est, gt = _trajectories()
    rot, trans = diag_real.rel_errors(est, gt)
    rot_r, trans_r = root.rel_errors(est, gt)
    np.testing.assert_allclose(rot, rot_r, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(trans, trans_r, rtol=1e-12, atol=1e-12)
    assert len(rot) == len(est) - 1 and rot.max() > 0.05
    ratios = diag_real.rotation_scale(est, gt, 16)
    want = _root_ratios(est, gt, 16)
    assert len(want) > 10
    np.testing.assert_allclose(ratios, want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------- profile_micro

def test_micro_alternatives_match_jax():
    """The ported broadcast-compare descriptor and group thinning against
    the root tool's own: the descriptor within float32 rounding of z (the
    bins are integer decisions on the same coordinates), the thinning
    exactly."""
    from sc_lego_loam_tpu.utils import synthetic

    cfg = tiny_test_config()
    desc_j, thin_j = _root_nested("profile_micro",
                                  ("desc_bcast", "thin_group"),
                                  dict(jnp=jnp, jax=jax, cfg=cfg))
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, 2, trajectory="figure8", radius=12.0, loops=0.05,
        noise=0.01, seed=11, shuffle=True)
    pts, msk = scans[-1], valids[-1]
    want = np.asarray(desc_j(jnp.asarray(pts), jnp.asarray(msk)))
    got = profile_micro.desc_bcast(torch.from_numpy(pts),
                                   torch.from_numpy(msk), cfg.sc).numpy()
    assert (want > 0).sum() > 50
    np.testing.assert_allclose(got, want, atol=1e-5)
    rng = np.random.default_rng(1)
    M = 5000
    p = rng.normal(0, 40, (M, 3)).astype(np.float32)
    m = rng.random(M) > 0.6
    for pad in (512, 2048):
        out_j, ok_j = thin_j(jnp.asarray(p), jnp.asarray(m), pad)
        out_t, ok_t = profile_micro.thin_group(torch.from_numpy(p),
                                               torch.from_numpy(m), pad)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


# ---------------------------------------------------------------- debug_fig8

FIG8_FRAMES = 6


def test_debug_fig8_first_frames_match_jax():
    """The first frames of the root tool's drive (tiny_test_config, the
    60-scan figure-8 of seed 7), each frame's twist and its error against
    ground truth, through the JAX calls of tools/debug_fig8.py:20-30 and
    through ``debug_fig8.twist_errors``: within 2e-4."""
    from sc_lego_loam_tpu import frontend, odometry
    from sc_lego_loam_tpu.ops import features as features_op
    from sc_lego_loam_tpu.utils import se3

    cfg = tiny_test_config()
    scans, valids, gt = debug_fig8.make_scans(tiny_torch())
    scans, valids = scans[:FIG8_FRAMES], valids[:FIG8_FRAMES]
    front = jax.jit(lambda p, v: frontend.run(cfg, p, v).cloud)
    extract = jax.jit(lambda c: features_op.extract(c, cfg.feat, cfg.cap))
    state = odometry.init_state(cfg)
    want = []
    for i in range(FIG8_FRAMES):
        fs = extract(front(jnp.asarray(scans[i]), jnp.asarray(valids[i])))
        state, _, xi = odometry.step(cfg, state, fs)
        if i == 0:
            continue
        T_gt = np.linalg.inv(gt[i - 1]) @ gt[i]
        xi_gt = np.asarray(se3.se3_log(jnp.asarray(T_gt, jnp.float32)))
        want.append((np.asarray(xi), np.asarray(xi) - xi_gt,
                     int(fs.sharp.mask.sum()), int(fs.flat.mask.sum())))
    rows = debug_fig8.twist_errors(tiny_torch(), scans, valids, gt, "cpu")
    assert [r["frame"] for r in rows] == list(range(1, FIG8_FRAMES))
    for r, (xi, err, sharp, flat) in zip(rows, want):
        np.testing.assert_allclose(r["xi"], xi, atol=2e-4)
        np.testing.assert_allclose(r["err"], err, atol=2e-4)
        assert (r["sharp"], r["flat"]) == (sharp, flat)
    assert np.abs(want[-1][0][3:]).max() > 0.2     # it really moved
    assert "sharp=" in debug_fig8.format_row(rows[0])
