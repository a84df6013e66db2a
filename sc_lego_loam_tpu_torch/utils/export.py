"""Map / trajectory export & checkpointing (port of
``sc_lego_loam_tpu/utils/export.py``).

Replaces the reference's end-of-run PCD dump (mapOptmization.cpp:756-781)
and adds full engine-state checkpoint / resume.

The checkpoint is one compressed NPZ.  It holds every key of the JAX
package's checkpoint under the same name and shape (keyframe store, loop
factors, Scan Context bank, ``correction``, ``pose``), so either package
loads the other's file, and beside them what a resumed run needs to go on
where the saved one stopped: the keyframes' odometry anchors
(``odom_pose``), ``last_kf_pose``, ``last_kf_odom``, ``loops_closed``,
``kf_dropped``, the whole every-scan state (``p.*``: odometry state, IMU
buffer, trajectory rings) and the host's cadence counters (``host.*``).
Keys a file lacks keep the values of the engine it is loaded into.

An engine with a mesh (banks sharded over 'kf') writes the same file: the
sharded leaves are gathered whole (``parallel.mesh.gather_full``, so every
rank of the group must call) and the first process writes; loading keeps
each rank's own rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_mod
from . import se3

# NPZ key of each MapperState leaf whose key is not its own field name.
_MAPPER_KEYS = {
    "kf.count": "kf_count", "kf.odom_pose": "odom_pose",
    "bank.desc": "sc_desc", "bank.ringkey": "sc_ringkey",
    "bank.count": "sc_count",
    "loops.i": "loop_i", "loops.j": "loop_j", "loops.z": "loop_z",
    "loops.count": "loop_count",
}
_HOST_FIELDS = ("last_map_time", "map_ticks", "loop_ticks", "_scans_fed")


def save_ply(path: str, points: np.ndarray):
    """ASCII PLY point cloud (readable by CloudCompare/Meshlab/Open3D)."""
    points = np.asarray(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def save_trajectory_tum(path: str, times: np.ndarray, poses: np.ndarray):
    """TUM format: t x y z qx qy qz qw (for external ATE tooling)."""
    with open(path, "w") as f:
        for t, T in zip(times, poses):
            R = T[:3, :3]
            # Rotation matrix -> quaternion (w last).
            w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2
            if w > 1e-6:
                qx = (R[2, 1] - R[1, 2]) / (4 * w)
                qy = (R[0, 2] - R[2, 0]) / (4 * w)
                qz = (R[1, 0] - R[0, 1]) / (4 * w)
            else:           # a half turn: through the axis-angle form
                aa = se3.so3_log(torch.as_tensor(
                    np.asarray(R), dtype=torch.float32)).numpy()
                ang = np.linalg.norm(aa)
                ax = aa / max(ang, 1e-9)
                qx, qy, qz = ax * np.sin(ang / 2)
                w = np.cos(ang / 2)
            f.write(f"{t:.6f} {T[0,3]:.6f} {T[1,3]:.6f} {T[2,3]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {w:.6f}\n")


def state_leaves(state, prefix=""):
    """(dotted path, tensor) of every leaf of a state NamedTuple."""
    for name, value in zip(state._fields, state):
        if isinstance(value, torch.Tensor):
            yield prefix + name, value
        else:
            yield from state_leaves(value, prefix + name + ".")


def _with_leaves(state, fn, prefix=""):
    """``state`` with every leaf replaced by ``fn(dotted path, tensor)``."""
    return type(state)(*(
        fn(prefix + name, value) if isinstance(value, torch.Tensor)
        else _with_leaves(value, fn, prefix + name + ".")
        for name, value in zip(state._fields, state)))


def _mapper_key(path: str) -> str:
    return _MAPPER_KEYS.get(path, path.rsplit(".", 1)[-1])


def _sharded(engine, path: str) -> bool:
    from ..pipeline import SHARDED_LEAVES
    return getattr(engine, "shard", None) is not None and \
        path in SHARDED_LEAVES


def checkpoint_arrays(engine) -> dict[str, np.ndarray]:
    """Everything ``save_checkpoint`` writes, by NPZ key (a mesh engine's
    sharded leaves gathered whole: every rank must call)."""
    out = {_mapper_key(path): (mesh_mod.gather_full(leaf, engine.shard)
                               if _sharded(engine, path) else leaf
                               ).cpu().numpy()
           for path, leaf in state_leaves(engine.m)}
    out.update(("p." + path, leaf.cpu().numpy())
               for path, leaf in state_leaves(engine.p))
    out.update(("host." + name.lstrip("_"), np.asarray(getattr(engine, name)))
               for name in _HOST_FIELDS)
    return out


def save_checkpoint(path: str, engine):
    """Serialize the engine's state (see the module docstring) to NPZ.
    With a mesh every rank calls and the first process writes."""
    arrays = checkpoint_arrays(engine)
    if not dist.is_initialized() or dist.get_rank() == 0:
        np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, engine):
    """Restore, in place, engine state saved by ``save_checkpoint`` of this
    package or of the JAX package.  The engine must have the capacities
    the file was saved with: a key of another shape raises.  A mesh
    engine keeps its own rows of the sharded leaves."""
    with np.load(path) as z:
        def restore(key, leaf, sharded=False):
            if key not in z.files:
                return leaf
            value = z[key]
            if sharded and value.shape[1:] == tuple(leaf.shape[1:]) and \
                    value.shape[0] == leaf.shape[0] * engine.shard.size:
                lo, rows = engine.shard.block(value.shape[0])
                value = value[lo:lo + rows]
            if value.shape != tuple(leaf.shape):
                raise ValueError(
                    f"{path}: {key} has shape {value.shape}, the engine's "
                    f"configuration needs {tuple(leaf.shape)}")
            return torch.from_numpy(value).to(device=leaf.device,
                                              dtype=leaf.dtype)

        engine.m = _with_leaves(
            engine.m, lambda p, leaf: restore(_mapper_key(p), leaf,
                                              _sharded(engine, p)))
        engine.p = _with_leaves(
            engine.p, lambda p, leaf: restore("p." + p, leaf))
        for name in _HOST_FIELDS:
            key = "host." + name.lstrip("_")
            if key in z.files:
                setattr(engine, name, z[key].item())
    return engine


def global_map_points(engine, max_points: int = 500_000) -> np.ndarray:
    """Assemble the global map (world frame) from the keyframe store: each
    keyframe's corner then surf points at its pose, in keyframe order (the
    publishGlobalMap analog, mO.cpp:784-826)."""
    kf = engine.map.kf
    n = int(kf.count)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    shard = getattr(engine, "shard", None)
    corner, corner_mask, surf, surf_mask = (
        mesh_mod.gather_full(x, shard)[:n]
        for x in (kf.corner, kf.corner_mask, kf.surf, kf.surf_mask))
    T = se3.pose6_to_mat(kf.poses6[:n])
    pts = se3.transform_points(T, torch.cat([corner, surf], 1))
    mask = torch.cat([corner_mask, surf_mask], 1)
    out = pts.cpu().numpy()[mask.cpu().numpy()]
    if len(out) > max_points:
        out = out[np.random.default_rng(0).permutation(len(out))[:max_points]]
    return out.astype(np.float32)
