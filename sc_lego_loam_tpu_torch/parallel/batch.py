"""Multi-sequence batch mapping (port of ``sc_lego_loam_tpu/parallel/batch.py``;
BASELINE.json config 4, "Multi-sequence batch mapping").

The reference is single-sequence (one ROS graph); mapping several MulRan
sequences means several runs and merging by hand.  Here, as in the JAX
package, sequences are a batch axis: every per-scan stage is the port's own
single-sequence function under ``torch.func.vmap``, so S sequences issue
about the launches of one.  The kNN is a custom op whose batching rule
makes one kernel call of all S items (``ops/cuda_knn.py``).

What cannot run under ``vmap`` runs outside it, once for the batch:
- the keyframe and descriptor bank writes: the vmapped step returns the new
  rows and their slots, and the engine writes the (S, K, ...) banks in place
  with one ``index_put_`` per field at ``[arange(S), slot]``;
- the host reads of a loop tick: the S x 2 detector verdicts in one read,
  ``closed.any()`` once, and one ``done.all()`` per GN iteration of the
  batched re-solve (``posegraph.solve_batched``); a sequence without a
  candidate is frozen with ``torch.where``, as the JAX package's
  ``lax.cond`` is under ``jax.vmap``.

Cross-sequence merging: ``find_cross_loops`` scores every keyframe of
sequence A against the whole Scan Context bank of B, ``verify_cross_loops``
ICP-verifies the best pairs (vmapped over the pairs: one batched k=1 kNN
call per ICP iteration), ``anchor_sequence`` re-anchors B rigidly from one
accepted cross factor, and ``merge_solve`` solves the S chains plus intra-
and cross-sequence loop factors as one multi-chain pose graph.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from .. import loop, mapping, odometry, posegraph
from ..config import PipelineConfig
from ..models import scan_context
from ..ops import icp
from ..pipeline import _odo_perception
from . import mesh as mesh_mod
from ..utils import se3
from ..utils.profiling import StageTimer


def _stack(state, n: int):
    """``n`` copies of a state tuple (or tensor) on a new leading axis."""
    if isinstance(state, torch.Tensor):
        return state.expand(n, *state.shape).contiguous()
    return type(state)(*(_stack(leaf, n) for leaf in state))


def _select(flag: torch.Tensor, new, old):
    """Per-leaf ``where(flag[s], new[s], old[s])`` over leading-S tuples."""
    return type(old)(*(torch.where(
        flag.reshape((-1,) + (1,) * (o.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def _map_one(cfg: PipelineConfig, st: mapping.MapState, last_kf_odom,
             odom_pose, corner, corner_m, surf, surf_m, outlier, outlier_m,
             t):
    """One sequence's mapping tick, with the JAX ``BatchEngine``'s own
    semantics (no IMU blend, no dropped-keyframe count).  Writes nothing:
    returns the keyframe rows and their slot for the caller to write."""
    c, cm, s, sm, o, om = mapping.downsample_scan(
        cfg, corner, corner_m, surf, surf_m, outlier, outlier_m)
    sub = mapping.build_submap(cfg, st.kf)
    T_guess = st.correction @ odom_pose
    pose = mapping.scan_to_map(cfg, T_guess, c, cm, torch.cat([s, o]),
                               torch.cat([sm, om]), *sub)
    correction = pose @ se3.mat_inv(odom_pose)
    should = mapping.should_insert_keyframe(cfg, st.last_kf_pose, pose)
    slot, room, rows = mapping.keyframe_rows(cfg, st.kf, pose, t, c, cm, s,
                                             sm, o, om, odom_pose=odom_pose)
    inserted = should & room
    return (slot[0], rows, inserted, pose, correction,
            torch.where(inserted, pose, st.last_kf_pose),
            torch.where(inserted, odom_pose, last_kf_odom))


def _descriptor_rows(cfg: PipelineConfig, bank, points, mask):
    desc = scan_context.make_descriptor(points, mask, cfg.sc)
    slot, room, desc_row, key_row = scan_context.append_rows(
        bank, desc, cfg.cap.max_keyframes)
    return slot[0], room, desc_row, key_row


class BatchEngine:
    """Runs S sequences in lockstep, one vmapped device step per scan index
    (pure data parallelism over the sequences).  The state is stacked on a
    leading S axis; the fused trajectories live in a device-side
    (S, max_scans, 4, 4) ring fetched once, by ``trajectory_array``.

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``.  The
    batch is lidar-only: the JAX ``BatchEngine`` carries no IMU buffer
    either (its ``_pre_deskew`` fails there).

    ``mesh`` (a ``DeviceMesh`` with a 'seq' axis): the sequences are split
    over the 'seq' group in contiguous blocks, and each rank holds and
    steps its ``n_local = n_seq / n`` sequences end to end, under the same
    ``vmap``, with no communication in a step (the JAX package's
    ``P("seq")``).  Every rank is handed all S sequences' scans and takes
    its own; ``trajectory_array`` gathers all sequences, and
    ``sequence_banks`` brings one sequence's banks to every rank for the
    cross-sequence functions."""

    def __init__(self, config: PipelineConfig, n_seq: int, mesh=None,
                 device="cuda"):
        self.mesh = mesh
        self.seq_shard = None if mesh is None else \
            mesh_mod.axis_shard(mesh, "seq")
        if self.seq_shard is not None:
            assert n_seq % self.seq_shard.size == 0, (
                f"{n_seq} sequences do not split over "
                f"{self.seq_shard.size} 'seq' ranks")
        if config.imu.enabled:
            raise ValueError(
                "BatchEngine runs lidar-only sequences: imu.enabled is not "
                "supported (the batch carries no IMU buffer)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchEngine(device='cuda'): no CUDA device; pass "
                "device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.n_seq = n_seq
        self.seq_lo, n = (0, n_seq) if self.seq_shard is None else \
            self.seq_shard.block(n_seq)
        self.n_local = n
        dev = self.device
        self.odo = _stack(odometry.init_state(config, dev), n)
        self.map = _stack(mapping.init_state(config, dev), n)
        self.bank = _stack(scan_context.init_bank(config, dev), n)
        self.loops = _stack(posegraph.init_loops(config, dev), n)
        eye = torch.eye(4, device=dev)
        self.last_kf_odom = _stack(eye, n)
        self.loops_closed = torch.zeros(n, dtype=torch.int32, device=dev)
        self.traj = _stack(_stack(eye, config.cap.max_scans), n)
        self._scan_i = 0
        self._map_ticks = 0
        self.loop_ticks = 0
        self.last_map_time = -1e9
        self.timer = StageTimer()
        self._seq = torch.arange(n, device=dev)

        cfg = config
        self._perception = vmap(
            lambda p, m, s: _odo_perception(cfg, p, m, s))
        self._mapping = vmap(
            lambda *a: _map_one(cfg, *a),
            in_dims=(0,) * 9 + (None,))
        self._descriptors = vmap(
            lambda b, p, m: _descriptor_rows(cfg, b, p, m))
        self._detect_sc = vmap(
            lambda b, c: scan_context.detect(cfg, b, loop._row(b.desc, c)))
        self._detect_rs = vmap(lambda kf, c: loop.detect_radius(cfg, kf, c))
        self._verify_sc = vmap(
            lambda kf, lo, c, i, yaw: loop.verify_and_add(
                cfg, kf, lo, c, *loop.sc_hypothesis(kf, i), yaw))
        self._verify_rs = vmap(
            lambda kf, lo, c, i: loop.verify_and_add(
                cfg, kf, lo, c, *loop.rs_hypothesis(kf, c, i), None))

    def process_scans(self, points, masks, t: float):
        """points: (S,N,3), masks: (S,N) (numpy or tensors).  Returns the
        fused poses (S,4,4) as a device tensor (no host sync outside a loop
        tick; fetch the trajectories at the end with
        ``trajectory_array``).  With a mesh: all S sequences' scans in,
        this rank's ``n_local`` poses out."""
        cfg = self.config
        if self.seq_shard is not None:
            points = points[self.seq_lo:self.seq_lo + self.n_local]
            masks = masks[self.seq_lo:self.seq_lo + self.n_local]
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        with self.timer.stage("perception"):
            self.odo, odom_poses, out_pts, out_mask = self._perception(
                points, masks, self.odo)

        if t - self.last_map_time >= cfg.mapping.process_interval:
            self.last_map_time = t
            with self.timer.stage("mapping"):
                self._mapping_tick(odom_poses, out_pts, out_mask, points,
                                   masks, t)
            self._map_ticks += 1
            # The loop cadence counts mapping ticks, as in the JAX package.
            if cfg.loop.enabled and \
                    self._map_ticks % cfg.loop.check_every_ticks == 0:
                with self.timer.stage("loop"):
                    self._loop_tick()
                self.loop_ticks += 1
        # The fused pose with this tick's correction.
        fused = self.map.correction @ odom_poses
        self.traj[:, min(self._scan_i, cfg.cap.max_scans - 1)] = fused
        self._scan_i += 1
        return fused

    def _mapping_tick(self, odom_poses, out_pts, out_mask, points, masks,
                      t: float):
        odo = self.odo
        t_dev = torch.full((), t, dtype=torch.float32, device=self.device)
        slot, rows, inserted, pose, correction, last_kf_pose, lko = \
            self._mapping(self.map, self.last_kf_odom, odom_poses,
                          odo.corner_last.xyz, odo.corner_last.mask,
                          odo.surf_last.xyz, odo.surf_last.mask, out_pts,
                          out_mask, t_dev)
        kf = self.map.kf
        for name, row in rows.items():
            getattr(kf, name).index_put_((self._seq, slot), row)
        kf = kf._replace(count=kf.count + inserted.to(torch.int32))
        self.map = mapping.MapState(kf=kf, correction=correction, pose=pose,
                                    last_kf_pose=last_kf_pose)
        self.last_kf_odom = lko

        # The descriptor goes in under ``inserted`` (the JAX BatchEngine's
        # rule; the single-sequence engine appends under ``should``).
        slot, room, desc_row, key_row = self._descriptors(self.bank, points,
                                                          masks)
        bank = self.bank
        bank.desc.index_put_((self._seq, slot), desc_row)
        bank.ringkey.index_put_((self._seq, slot), key_row)
        self.bank = bank._replace(
            count=bank.count + (inserted & room).to(torch.int32))

    def _loop_tick(self):
        """Every sequence's loop-closure tick (the JAX package's
        ``_batch_loop``: ``loop.device_tick`` per sequence and the
        correction bookkeeping of ``pipeline.loop_step``).  Host reads: the
        S x 2 detector verdicts together, ``closed.any()``, and one per GN
        iteration of the batched re-solve."""
        cfg = self.config
        st = self.map
        kf = st.kf
        cur = torch.clamp(kf.count - 1, min=0)
        sc_idx, _, sc_yaw = self._detect_sc(self.bank, cur)
        rs_idx = self._detect_rs(kf, cur)
        run_sc = sc_idx >= 0
        run_rs = (rs_idx >= 0) & (rs_idx != sc_idx)
        any_sc, any_rs = torch.stack([run_sc, run_rs]).any(-1).tolist()

        loops = self.loops
        closed = torch.zeros(self.n_local, dtype=torch.bool,
                             device=self.device)
        if any_sc:
            new, ok = self._verify_sc(kf, loops, cur, sc_idx, sc_yaw)
            loops = _select(run_sc, new, loops)
            closed = closed | (ok & run_sc)
        if any_rs:
            new, ok = self._verify_rs(kf, loops, cur, rs_idx)
            loops = _select(run_rs, new, loops)
            closed = closed | (ok & run_rs)
        self.loops = loops
        if not ((any_sc or any_rs) and bool(closed.any())):
            return
        kf = kf._replace(poses6=posegraph.solve_batched(
            cfg, kf.poses6, kf.count, kf.odom_z, loops, closed))
        new_pose = se3.pose6_to_mat(kf.poses6[self._seq, cur])
        c = closed[:, None, None]
        self.map = mapping.MapState(
            kf=kf,
            correction=torch.where(
                c, new_pose @ se3.mat_inv(self.last_kf_odom), st.correction),
            pose=torch.where(c, new_pose, st.pose),
            last_kf_pose=torch.where(c, new_pose, st.last_kf_pose))
        self.loops_closed = self.loops_closed + closed.to(torch.int32)

    def trajectory_array(self, seq: int | None = None):
        """(S,N,4,4) fused trajectories so far (one fetch), or one
        sequence's (N,4,4); with a mesh, every sequence's, gathered over
        the 'seq' group (every rank of it must call)."""
        n = min(self._scan_i, self.config.cap.max_scans)
        traj = self.traj[:, :n].contiguous()
        if self.seq_shard is not None:
            traj = mesh_mod.exchange(traj, self.seq_shard).reshape(
                (self.n_seq,) + tuple(traj.shape[1:]))
        out = traj.cpu().numpy()
        return out if seq is None else out[seq]

    def sequence_banks(self, s: int):
        """(KeyframeStore, DescriptorBank) of sequence ``s``, unstacked,
        on every rank: with a mesh the rank that holds ``s`` broadcasts
        them over the 'seq' group (every rank of it must call).  With them
        ``find_cross_loops``, ``verify_cross_loops``, ``anchor_sequence``
        and ``merge_solve`` run as they are on a pair held apart."""
        kf, bank = self.map.kf, self.bank
        if self.seq_shard is None:
            return (type(kf)(*(x[s] for x in kf)),
                    type(bank)(*(x[s] for x in bank)))
        owner = s // self.n_local
        i = s - owner * self.n_local if owner == self.seq_shard.index else 0

        def one(state):
            return type(state)(*(mesh_mod.bring(x[i], owner, self.seq_shard)
                                 for x in state))

        return one(kf), one(bank)


# Keyframes of A scored per vmapped call of ``find_cross_loops``: bounds
# the (chunk, K, S) distance block (126 MB at 16384 keyframes).
_CROSS_CHUNK = 32


def find_cross_loops(config: PipelineConfig, bank_a, bank_b,
                     max_pairs: int = 8):
    """Cross-sequence loop candidates: every keyframe of A scored against
    the whole Scan Context bank of B at every column shift (the all-shifts
    product of ``scan_context.distance_all_shifts``), then the best
    ``max_pairs`` pairs by a stable sort, accepted under SC_DIST_THRES.

    Returns (ia (P,), ib (P,), dist (P,), yaw (P,), ok (P,)) device
    tensors.  Reads A's count once: rows past ``count + max_pairs`` hold
    the 1e9 of an empty row, and a stable sort puts every such row after
    all of those before it, so they are never among the first
    ``max_pairs`` and are not scored (at the full bank's 16384 keyframes
    that is the difference between ~100 rows and 16384)."""
    sc = config.sc
    Ka, Kb = bank_a.desc.shape[0], bank_b.desc.shape[0]
    dev = bank_a.desc.device
    n = min(Ka, int(bank_a.count) + max_pairs)
    kb_ok = torch.arange(Kb, device=dev)[:, None] < bank_b.count

    def one(qa):
        d = scan_context.distance_all_shifts(qa, bank_b.desc)   # (Kb,S)
        d = torch.where(kb_ok, d, 1e9)
        k = torch.argmin(d.amin(-1))
        row = loop._row(d, k)
        return k, row.amin(), torch.argmin(row)

    parts = [vmap(one)(bank_a.desc[s:min(s + _CROSS_CHUNK, n)])
             for s in range(0, n, _CROSS_CHUNK)]
    ib, dist, shift = (torch.cat(p) for p in zip(*parts))
    dist = torch.where(torch.arange(n, device=dev) < bank_a.count, dist, 1e9)
    order = torch.argsort(dist, stable=True)[:max_pairs]
    yaw = shift[order].to(torch.float32) * (2.0 * math.pi / sc.num_sector)
    ok = dist[order] < sc.dist_threshold
    return (order.to(torch.int32), ib[order].to(torch.int32), dist[order],
            yaw, ok)


def verify_cross_loops(config: PipelineConfig, kf_a, kf_b, ia, ib, yaw, ok):
    """ICP-verify cross-sequence candidates (the reference's SC-loop
    verification, mO.cpp:1053-1093, between two keyframe banks), vmapped
    over the P pairs: each ICP iteration is one k=1 kNN call of P items.
    A's keyframe cloud is placed at B's candidate pose with the SC yaw
    seeding the ICP.  The gates are fitness and overlap only, as in the
    JAX package (no orientation gate: the two chains' frames are unrelated
    before the merge).

    Returns (Z (P,4,4), fitness (P,), accept (P,)): Z is the between
    measurement X_a(ia)^-1 X_b(ib) after the ICP correction."""
    lcfg = config.loop

    def one(i_a, i_b, yw, o):
        place = se3.pose6_to_mat(loop._row(kf_b.poses6, i_b))
        src, src_mask = loop.keyframe_cloud(config, kf_a, i_a, place)
        dst, dst_mask = loop.history_submap(config, kf_b, i_b)
        zero = torch.zeros_like(yw)
        Rz = se3.rt_to_mat(se3.euler_zyx_to_mat(-yw, zero, zero),
                           torch.zeros(3, dtype=yw.dtype, device=yw.device))
        T0 = place @ Rz @ se3.mat_inv(place)
        dT, fitness, inliers = icp.align(config, src, src_mask, dst,
                                         dst_mask, T0=T0)
        Z = se3.mat_inv(dT @ place) @ place
        accept = o & (fitness < lcfg.fitness_threshold) & \
            (inliers >= lcfg.min_inlier_ratio)
        return Z, fitness, accept

    return vmap(one)(ia.to(torch.int64), ib.to(torch.int64), yaw, ok)


def anchor_sequence(poses6_b, count_b, pose6_a, Z, ib):
    """Rigidly re-anchor sequence B so that the cross factor (a, b=ib, Z)
    holds exactly: poses_b <- C @ poses_b with C = (X_a @ Z) @ X_b(ib)^-1.

    The initialization step before ``merge_solve``: its Cauchy-robust GN
    treats residuals far outside the kernel scale as outliers, so a
    placement tens of meters off leaves every cross factor downweighted to
    ~0.  One rigid re-anchor from the best cross factor puts the graph in
    the basin; ``merge_solve`` then spreads the residual."""
    Xb = se3.pose6_to_mat(poses6_b)
    ib = torch.as_tensor(ib, device=Xb.device).to(torch.int64)
    target = se3.pose6_to_mat(pose6_a) @ Z
    C = target @ se3.mat_inv(loop._row(Xb, ib))
    out = se3.mat_to_pose6(C @ Xb)
    ok = torch.arange(poses6_b.shape[0], device=Xb.device) < count_b
    return torch.where(ok[:, None], out, poses6_b)


def merge_solve(config: PipelineConfig, poses6, counts, odom_z, loops):
    """Joint multi-sequence pose-graph solve (BASELINE.json config 4).

    poses6: (S,K,6) per-sequence keyframe poses; counts: (S,); odom_z:
    (S,K,4,4) per-sequence odometry factors (odom_z[s,0] = prior pose of
    sequence s's node 0); loops: LoopFactors with GLOBAL node ids
    (s * K + k), intra- and cross-sequence factors mixed freely.

    The S chains concatenate into one ``posegraph.solve``: each sequence
    start becomes a free edge whose Z is the current relative pose (zero
    residual, a pure parametrization), so sequence 0 is anchored by the
    prior and every other sequence's placement is determined by the
    cross-sequence factors.  Returns optimized (S,K,6)."""
    S, K = poses6.shape[:2]
    dev = poses6.device
    flat = poses6.reshape(S * K, 6)
    X = se3.pose6_to_mat(flat)
    seam = K * torch.arange(1, S, device=dev)
    odom_flat = odom_z.reshape(S * K, 4, 4).index_copy(
        0, seam, se3.mat_inv(X[seam - 1]) @ X[seam])
    node_mask = (torch.arange(K, device=dev)[None, :]
                 < counts[:, None]).reshape(-1)
    out = posegraph.solve(
        config, flat, torch.full((), S * K, dtype=torch.int32, device=dev),
        odom_flat, loops, node_mask=node_mask, free_edges=seam)
    return out.reshape(S, K, 6)
