"""Point-to-line and point-to-plane residual geometry (port of
``sc_lego_loam_tpu/ops/residuals.py``)."""

from __future__ import annotations

import torch

_EPS = 1e-9


def point_to_line(p, a, b):
    """Unsigned distance from p to the line through a, b. Batched (...,3)."""
    cr = torch.linalg.cross(p - a, p - b)
    num = torch.linalg.vector_norm(cr, dim=-1)
    den = torch.linalg.vector_norm(a - b, dim=-1)
    return num / torch.clamp(den, min=_EPS)


def point_to_plane(p, a, b, c):
    """Signed distance from p to the plane through a, b, c. Batched (...,3)."""
    n = torch.linalg.cross(b - a, c - a)
    nn = torch.linalg.vector_norm(n, dim=-1)
    return ((p - a) * n).sum(-1) / torch.clamp(nn, min=_EPS)


def point_to_plane_nd(p, normal, d):
    """Signed distance to a plane given unit normal + offset (n.x + d)."""
    return (p * normal).sum(-1) + d
