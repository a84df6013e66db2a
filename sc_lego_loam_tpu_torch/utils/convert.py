"""Engine state from the JAX package to this port.

``perception_state`` and ``mapper_state`` take the JAX engine's
``PerceptionState`` / ``MapperState`` with every leaf already a numpy array
(``jax.tree.map(np.asarray, state)``: this module never sees jax) and
return the port's state on ``device``.  Fields are matched by name (the
IMU buffer, the loop-factor bank and ``loops_closed`` come across with the
rest).  With it, one step of both packages can run from the same mid-run
state; ``utils/export.py`` carries state across by file.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import pipeline


def _is_state(cls) -> bool:
    return isinstance(cls, type) and issubclass(cls, tuple) and \
        hasattr(cls, "_fields")


def to_torch(cls, src, device):
    """Build the NamedTuple ``cls`` from ``src`` field by field, turning
    every numpy leaf into a tensor on ``device`` (dtype kept)."""
    hints = typing.get_type_hints(cls)
    out = {}
    for name in cls._fields:
        value = getattr(src, name)
        if _is_state(hints[name]):
            out[name] = to_torch(hints[name], value, device)
        else:
            out[name] = torch.from_numpy(np.array(value, copy=True)).to(device)
    return cls(**out)


def perception_state(src, device) -> pipeline.PerceptionState:
    return to_torch(pipeline.PerceptionState, src, device)


def mapper_state(src, device) -> pipeline.MapperState:
    return to_torch(pipeline.MapperState, src, device)


def load_batch_state(engine, src) -> None:
    """Carry a JAX ``BatchEngine``'s state into the port's ``engine`` (a
    ``parallel.batch.BatchEngine`` of the same configuration and S).
    ``src`` has the JAX engine's attributes with every state leaf already
    numpy (S-leading): ``odo``, ``map``, ``bank``, ``loops``,
    ``last_kf_odom``, ``loops_closed``, ``traj``, and the host counters
    ``_scan_i``, ``_map_ticks``, ``last_map_time``."""
    dev = engine.device
    for name in ("odo", "map", "bank", "loops"):
        setattr(engine, name, to_torch(type(getattr(engine, name)),
                                       getattr(src, name), dev))
    for name in ("last_kf_odom", "loops_closed", "traj"):
        setattr(engine, name, torch.from_numpy(
            np.array(getattr(src, name), copy=True)).to(dev))
    engine._scan_i = int(src._scan_i)
    engine._map_ticks = int(src._map_ticks)
    engine.last_map_time = float(src.last_map_time)
