"""Sort-free masked compaction (port of ``sc_lego_loam_tpu/ops/compact.py``):
out[j] = values[i] where i is the j-th set index of mask."""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, pad: int):
    """int64 indices of the first ``pad`` set elements of mask and a
    validity mask.  Positions beyond the population count map to 0."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1        # destination slot
    sel = mask & (pos < pad)
    src = torch.arange(n, dtype=torch.int64, device=mask.device)
    zero = torch.zeros_like(src)
    idx = torch.zeros(pad, dtype=torch.int64, device=mask.device
                      ).scatter_reduce(0, torch.where(sel, pos, zero),
                                       torch.where(sel, src, zero), "amax")
    count = torch.clamp(mask.sum(), max=pad)
    ok = torch.arange(pad, device=mask.device) < count
    return idx, ok


def compact(values: torch.Tensor, mask: torch.Tensor, pad: int, fill=0):
    """Gather the masked rows of ``values`` ((N,...) -> (pad,...))."""
    idx, ok = compact_indices(mask, pad)
    out = values[idx]
    okb = ok.reshape((pad,) + (1,) * (values.ndim - 1))
    return torch.where(okb, out, torch.full_like(out, fill)), ok
