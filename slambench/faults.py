"""Faults planted under the timed path, each of which ``correct`` must
catch (the benchmark's own runs plant none).  Each is a context manager
that patches the port's module or class attributes before an engine is
built and restores them on exit; the patched step is what the engine runs
eagerly or captures into its CUDA graphs.

- ``unchanged``: the odometry step returns its state unchanged (the scan's
  pose is the last one);
- ``altered``: one published pose, of scan ``at``, is moved 10 m where
  the fused pose is produced;
- ``half_batch``: a fleet's batched perception step leaves the second half
  of its streams out (their odometry state is not advanced);
- ``map_unchanged``: the mapping step returns its state unchanged (no
  keyframe, no correction);
- ``map_altered``: the pose of one mapping tick, that of scan ``at`` or
  the one before it (a tick every 3rd scan), is moved 10 m where
  scan-to-map produces it (the tick's correction and keyframe carry it);
- ``loop_unchanged``: the loop step returns its state unchanged (no
  factor is kept, nothing is re-solved);
- ``resolve_skipped``: a loop tick keeps the factors it accepts but not
  the re-solved keyframe poses;
- ``factor_altered``: every loop factor a tick accepts is stored moved
  10 m.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged():
    from sc_lego_loam_tpu_torch import odometry
    orig = odometry.step

    def step(config, state, feats, xi_prior=None):
        _, _, rel = orig(config, state, feats, xi_prior)
        return state, state.pose, rel

    return _patched(odometry, "step", step)


def _moved(pose, hit):
    """``pose`` moved 10 m along x where ``hit`` (device ops only: no host
    copy, which a graph capture refuses)."""
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device)
    return pose + (10.0 * hit.to(pose.dtype)) * torch.outer(eye[0], eye[3])


@contextlib.contextmanager
def altered(at: int):
    from sc_lego_loam_tpu_torch import pipeline
    from sc_lego_loam_tpu_torch.parallel import batch
    orig_step, orig_record = pipeline.perception_step, \
        batch.BatchEngine._record

    def perception_step(config, state, correction, points, mask, t):
        out = orig_step(config, state, correction, points, mask, t)
        hit = state.scan_i == at
        fused = _moved(out[4], hit)
        i = torch.clamp(state.scan_i.to(torch.int64),
                        max=config.cap.max_scans - 1).reshape(1)
        out[0].traj.index_copy_(0, i, fused[None])
        return out[:4] + (fused,)

    def record(self, st, i):
        fused = orig_record(self, st, i)
        moved = fused.clone()
        moved[0] = _moved(fused[0], i == at)
        return moved

    with _patched(pipeline, "perception_step", perception_step), \
            _patched(batch.BatchEngine, "_record", record):
        yield


def _first_rows(new, old, h):
    """``new``'s leaves with rows h: of ``old`` (nested tuples)."""
    if isinstance(new, torch.Tensor):
        return torch.cat([new[:h], old[h:]])
    return type(new)(*(_first_rows(a, b, h) for a, b in zip(new, old)))


def half_batch():
    from sc_lego_loam_tpu_torch.parallel import batch
    orig = batch.BatchEngine._perceive

    def perceive(self, st, points, masks, i):
        new, out_pts, out_mask, _ = orig(self, st, points, masks, i)
        h = (self.n_local + 1) // 2
        new = new._replace(odo=_first_rows(new.odo, st.odo, h))
        return new, out_pts, out_mask, self._record(new, i)

    return _patched(batch.BatchEngine, "_perceive", perceive)


def map_unchanged():
    from sc_lego_loam_tpu_torch import pipeline
    orig = pipeline.mapping_step

    def mapping_step(config, mst, *args, **kw):
        orig(config, mst, *args, **kw)
        return mst

    return _patched(pipeline, "mapping_step", mapping_step)


@contextlib.contextmanager
def map_altered(at: int):
    from sc_lego_loam_tpu_torch import mapping
    orig = mapping.scan_to_map
    runs = []         # a device counter of the runs, made on the first

    def scan_to_map(config, T_guess, *args):
        pose = orig(config, T_guess, *args)
        if not runs:
            runs.append(torch.zeros((), dtype=torch.int32,
                                    device=pose.device))
        runs[0].add_(1)
        return _moved(pose, runs[0] == at // 3 + 1)

    with _patched(mapping, "scan_to_map", scan_to_map):
        yield


def loop_unchanged():
    from sc_lego_loam_tpu_torch import pipeline
    orig = pipeline.loop_step

    def loop_step(config, mst, mesh=None):
        orig(config, mst, mesh)
        return mst

    return _patched(pipeline, "loop_step", loop_step)


def resolve_skipped():
    from sc_lego_loam_tpu_torch import loop
    orig = loop.device_tick

    def device_tick(config, kf, bank, loops, cur_desc, mesh=None):
        _, new_loops, closed = orig(config, kf, bank, loops, cur_desc, mesh)
        return kf, new_loops, closed

    return _patched(loop, "device_tick", device_tick)


def factor_altered():
    from sc_lego_loam_tpu_torch import loop
    orig = loop.device_tick

    def device_tick(config, kf, bank, loops, cur_desc, mesh=None):
        kf, new, closed = orig(config, kf, bank, loops, cur_desc, mesh)
        rows = torch.arange(new.z.shape[0], device=new.z.device)
        hit = (rows >= loops.count) & (rows < new.count)
        return kf, new._replace(z=_moved(new.z, hit[:, None, None])), closed

    return _patched(loop, "device_tick", device_tick)


FAULTS = {"unchanged": lambda at: unchanged(),
          "altered": altered,
          "half_batch": lambda at: half_batch(),
          "map_unchanged": lambda at: map_unchanged(),
          "map_altered": map_altered,
          "loop_unchanged": lambda at: loop_unchanged(),
          "resolve_skipped": lambda at: resolve_skipped(),
          "factor_altered": lambda at: factor_altered()}
