"""Edge/planar feature extraction (port of ``sc_lego_loam_tpu/ops/features.py``;
reference featureAssociation.cpp:621-784).

Each (ring x section) slot ranks its candidates once, then a greedy
pick-and-suppress pass over the small candidate list restates the
reference's sequential walk.  Candidate ranking uses a STABLE descending
sort so ties go to the lower position, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CapacityConfig, FeatureConfig

from .compact import compact_indices
from .compaction import SegmentedCloud
from .voxel import voxel_decimate


class FeatureCloud(NamedTuple):
    """Padded feature list."""

    xyz: torch.Tensor       # (P,3)
    mask: torch.Tensor      # (P,) bool
    ring: torch.Tensor      # (P,) int32 — scan ring
    rel_time: torch.Tensor  # (P,) intra-scan relative time


class FeatureSet(NamedTuple):
    sharp: FeatureCloud        # <=2/section edges
    less_sharp: FeatureCloud   # <=20/section edges
    flat: FeatureCloud         # <=4/section ground planes
    less_flat: FeatureCloud    # everything label<=0, voxel-DS 0.2


def empty_cloud(pad: int, device) -> FeatureCloud:
    return FeatureCloud(
        xyz=torch.zeros((pad, 3), dtype=torch.float32, device=device),
        mask=torch.zeros(pad, dtype=torch.bool, device=device),
        ring=torch.zeros(pad, dtype=torch.int32, device=device),
        rel_time=torch.zeros(pad, dtype=torch.float32, device=device))


def _top_k(score: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties to lower index."""
    val, sel = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[..., :k], sel[..., :k]


def curvature(cloud: SegmentedCloud, feat: FeatureConfig, neighbor_mask=None):
    """c[i] = (sum_{1<=|l|<=5} r[i+l] - 10 r[i])^2 over compacted ring order
    (fA.cpp:621-641).  ``neighbor_mask``: neighbors outside it contribute
    zero range difference (the ground planarity test).
    Returns (curv, curv_valid)."""
    r = cloud.rng
    H, W = r.shape
    k = feat.curvature_halfwidth
    if neighbor_mask is None:
        acc = -2.0 * k * r
        for l in range(1, k + 1):
            acc = acc + torch.roll(r, l, 1) + torch.roll(r, -l, 1)
    else:
        acc = torch.zeros_like(r)
        for l in range(1, k + 1):
            for sh in (l, -l):
                nb_ok = torch.roll(neighbor_mask, sh, 1)
                acc = acc + torch.where(nb_ok, torch.roll(r, sh, 1) - r, 0.0)
    curv = acc * acc
    pos = torch.arange(W, device=r.device)[None, :]
    ok = (pos >= k) & (pos <= cloud.count[:, None] - 1 - k) & cloud.valid
    return curv, ok


def occlusion_mask(cloud: SegmentedCloud, feat: FeatureConfig) -> torch.Tensor:
    """Occluded / parallel-beam pixels to exclude from picking
    (fA.cpp:643-678). Returns (H,W) bool 'pre-picked'."""
    r = cloud.rng
    H, W = r.shape
    col = cloud.col
    nxt_r = torch.roll(r, -1, 1)
    nxt_c = torch.roll(col, -1, 1)
    pos = torch.arange(W, device=r.device)[None, :]
    pair_ok = pos + 1 < cloud.count[:, None]
    close_cols = ((nxt_c - col).abs() < feat.occlusion_col_gap) & pair_ok
    a = close_cols & (r - nxt_r > feat.occlusion_range_gap)
    b = close_cols & (nxt_r - r > feat.occlusion_range_gap)
    marked = torch.zeros((H, W), dtype=torch.bool, device=r.device)
    for l in range(0, 6):
        marked |= torch.roll(a, -l, 1)
    for l in range(1, 7):
        marked |= torch.roll(b, l, 1)
    prv_r = torch.roll(r, 1, 1)
    par = ((prv_r - r).abs() > feat.parallel_beam_ratio * r) & \
          ((nxt_r - r).abs() > feat.parallel_beam_ratio * r)
    marked |= par
    return marked & cloud.valid


def _gather_row(a, idx):
    """a (H,W), idx (H,...) -> a[h, idx[h,...]]."""
    H = a.shape[0]
    return torch.gather(a, 1, idx.reshape(H, -1)).reshape(idx.shape)


def _suppress_positions(col, idx, count, feat: FeatureConfig):
    """Positions to mark picked around a pick at ``idx`` (per ring), with
    the column-gap early stop (fA.cpp:720-732).
    Returns (positions (H,S,11) int64, mask (H,S,11) bool)."""
    H, W = col.shape
    kh = feat.suppress_halfwidth
    offs = torch.arange(-kh, kh + 1, device=col.device)
    pos = idx[..., None] + offs
    pos_c = torch.clamp(pos, 0, W - 1)
    colg = _gather_row(col, pos_c)
    gaps = torch.diff(colg, dim=-1).abs()
    right_ok = torch.cumprod((gaps[..., kh:] <= feat.suppress_col_gap)
                             .to(torch.int32), -1).bool()
    left_gaps = gaps[..., :kh].flip(-1)
    left_ok = torch.cumprod((left_gaps <= feat.suppress_col_gap)
                            .to(torch.int32), -1).bool().flip(-1)
    center = torch.ones(pos.shape[:-1] + (1,), dtype=torch.bool,
                        device=col.device)
    ok = torch.cat([left_ok, center, right_ok], -1)
    in_row = (pos >= 0) & (pos < count[:, None, None])
    return pos_c, ok & in_row


def _row_marks(W, pos, mask):
    """(H,W) bool with out[h,w] = any(pos[h,...]==w & mask[h,...])."""
    H = pos.shape[0]
    p = torch.where(mask, pos, W).reshape(H, -1)
    out = torch.zeros((H, W + 1), dtype=torch.bool, device=pos.device)
    out.scatter_(1, p, True)
    return out[:, :W]


def _greedy_pick(pos, has, chain_id, feat: FeatureConfig):
    """Greedy pick-and-suppress on rank-sorted (H,S,KC) candidates: r is
    picked iff no better picked candidate sits within +-suppress_halfwidth
    positions on an unbroken column-gap chain."""
    KC = pos.shape[-1]
    near = (pos[..., :, None] - pos[..., None, :]).abs() \
        <= feat.suppress_halfwidth
    same_chain = chain_id[..., :, None] == chain_id[..., None, :]
    M = near & same_chain & has[..., :, None] & has[..., None, :]
    picked = torch.zeros_like(has)
    picked[..., 0] = has[..., 0]
    for r in range(1, KC):
        supp = (picked[..., :r] & M[..., :r, r]).any(-1)
        picked[..., r] = has[..., r] & ~supp
    return picked


def _scatter_label(label, pos, flag, val):
    """label[h, pos[h,...]] <- val where flag."""
    return torch.where(_row_marks(label.shape[1], pos, flag),
                       torch.full_like(label, val), label)


def extract(cloud: SegmentedCloud, feat: FeatureConfig,
            cap: CapacityConfig, sparse_picks: bool = True) -> FeatureSet:
    """``sparse_picks=False`` (the dense-query engine configuration) skips
    everything only the reference's sparse pick sets consume; sharp/flat
    then come back empty."""
    H, W = cloud.rng.shape
    dev = cloud.rng.device
    S = feat.sections
    curv, curv_ok = curvature(cloud, feat)
    occl = occlusion_mask(cloud, feat)

    n = torch.clamp(cloud.count, min=1).to(torch.int64)          # (H,)
    # Sections are contiguous spans of the compacted row (fA.cpp:691-694).
    SEC_L = -(-W // S) + 1
    s_ar = torch.arange(S, device=dev)[None, :]
    sec_start = (s_ar * n[:, None]) // S                          # (H,S)
    sec_end = ((s_ar + 1) * n[:, None]) // S
    sec_off = torch.arange(SEC_L, device=dev)
    sec_pos = torch.clamp(sec_start[..., None] + sec_off, 0, W - 1)
    sec_in = sec_off[None, None, :] < (sec_end - sec_start)[..., None]

    # Column-gap chain ids (fA.cpp:720-732).
    brk = ((cloud.col - torch.roll(cloud.col, 1, 1)).abs()
           > feat.suppress_col_gap) & (torch.arange(W, device=dev) > 0)
    chain = torch.cumsum(brk.to(torch.int32), 1)

    NEG = -1.0

    # ---- edge picks: one top-KC pass + greedy suppression ----
    KC = min(32, SEC_L - 1)
    cand = curv_ok & ~occl & (curv > feat.edge_threshold) & ~cloud.ground
    score_r = torch.where(cand, curv, NEG)
    score = torch.where(sec_in, _gather_row(score_r, sec_pos), NEG)
    val, sel = _top_k(score, KC)
    pos = torch.gather(sec_pos, -1, sel)
    has = val > 0.0
    picked = _greedy_pick(pos, has, _gather_row(chain, pos), feat)
    rank = torch.cumsum(picked.to(torch.int32), -1)
    sharp_f = picked & (rank <= feat.edge_per_section)
    less_f = picked & (rank <= feat.edge_less_per_section)

    label = torch.zeros((H, W), dtype=torch.int8, device=dev)
    label = _scatter_label(label, pos, less_f, 1)

    rings = torch.arange(H, dtype=torch.int32, device=dev)[:, None] \
        .expand(H, W).reshape(-1)
    xyz_flat = cloud.xyz.reshape(-1, 3)
    rel_flat = cloud.rel_time.reshape(-1)

    def gather_class(mask, pad):
        idx, ok = compact_indices(mask.reshape(-1), pad)
        return FeatureCloud(
            xyz=torch.where(ok[:, None], xyz_flat[idx], 0.0),
            mask=ok,
            ring=torch.where(ok, rings[idx], 0),
            rel_time=torch.where(ok, rel_flat[idx], 0.0))

    if sparse_picks:
        label = _scatter_label(label, pos, sharp_f, 2)

        # Suppression zones of the edge picks, for the surf phase.
        spos, smask = _suppress_positions(cloud.col, pos.reshape(H, -1),
                                          cloud.count, feat)
        smask &= less_f.reshape(H, -1)[..., None]
        supp_map = _row_marks(W, spos, smask)

        # ---- surf picks (ground planarity against ground neighbors) ----
        gcurv, _ = curvature(cloud, feat,
                             neighbor_mask=cloud.ground & cloud.valid)
        KS = min(8, SEC_L - 1)
        BIG_F = 1e18
        excl = supp_map | (occl & ~cloud.ground)
        cand_s = curv_ok & ~excl & (gcurv < feat.surf_threshold) & \
            cloud.ground
        score_sr = torch.where(cand_s, -gcurv, -BIG_F)
        score_s = torch.where(sec_in, _gather_row(score_sr, sec_pos), -BIG_F)
        val_s, sel_s = _top_k(score_s, KS)
        pos_s = torch.gather(sec_pos, -1, sel_s)
        has_s = val_s > -BIG_F * 0.5
        picked_s = _greedy_pick(pos_s, has_s, _gather_row(chain, pos_s),
                                feat)
        rank_s = torch.cumsum(picked_s.to(torch.int32), -1)
        flat_f = picked_s & (rank_s <= feat.surf_per_section)
        neg = _row_marks(W, pos_s, flat_f)
        label = torch.where(neg & (label == 0),
                            torch.full_like(label, -1), label)
        sharp = gather_class(label == 2, cap.sharp_pad)
        flat = gather_class(label == -1, cap.flat_pad)
    else:
        sharp = empty_cloud(cap.sharp_pad, dev)
        flat = empty_cloud(cap.flat_pad, dev)

    less_sharp = gather_class(label >= 1, cap.less_sharp_pad)

    # Less-flat: every in-range point not picked as an edge (fA.cpp:771-782),
    # voxel-decimated at 0.2 m to one representative return per voxel.
    lf_mask = curv_ok & (label <= 0)
    ds_pts, ds_mask, ds_idx = voxel_decimate(
        xyz_flat, lf_mask.reshape(-1), feat.less_flat_leaf, cap.less_flat_pad,
        table_bits=18, return_indices=True)
    less_flat = FeatureCloud(
        xyz=ds_pts, mask=ds_mask,
        ring=torch.where(ds_mask, rings[ds_idx], 0),
        rel_time=torch.where(ds_mask, rel_flat[ds_idx], 0.0))
    return FeatureSet(sharp=sharp, less_sharp=less_sharp, flat=flat,
                      less_flat=less_flat)
