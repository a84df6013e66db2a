"""Engine state from the JAX package to this port.

``perception_state`` and ``mapper_state`` take the JAX engine's
``PerceptionState`` / ``MapperState`` with every leaf already a numpy array
(``jax.tree.map(np.asarray, state)``: this module never sees jax) and
return the port's state on ``device``.  Fields are matched by name (the
loop-factor bank and ``loops_closed`` come across with the rest), so the
one part the port does not carry, the IMU buffer, is dropped.  With it, one
step of both packages can run from the same mid-run state.
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
