"""One scan-to-map research taken apart: kNN, gather + fit, and the LM
chain (the counterpart of the JAX package's ``tools/profile_s2m.py``).

    python -m sc_lego_loam_tpu_torch.tools.profile_s2m [--device cuda]

On the state of an engine warmed on ``profile_iters``' 8 scans: the submap
sizes; the 5-NN of the surf queries and of the corner queries in the
submap (``mapping._make_knn5``: the CUDA kernel of ``csrc/knn.cu`` on the
card, at the pads ``scan_to_map`` gives it, the queries prefix-compacted
once as it does); surf and corner geometry (``mapping._surf_geometry`` /
``_corner_geometry``: the kNN, the gather of the neighbours and the plane
fit / line eigen); then ``scan_to_map`` at (max_iterations,
research_every) = (8, 3), (8, 8), (1, 1) and ``odometry.step`` at (15, 2),
(15, 5), (8, 4), convergence deltas zeroed.  Every row is timed as
``profile_iters`` times it, a chain of 8 calls (each part's query moved by
0 times the previous result, as the JAX tool serializes its scan), and
prints its k=5 kNN calls per call (``cuda_knn.launches``: one per kNN
part, two per research of ``scan_to_map``).  ``--device`` defaults to
``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse

import torch

from .. import mapping
from ..config import synthetic_config
from ..ops.compact import compact
from . import bench, profile_iters

MAP_GRID = [(8, 3), (8, 8), (1, 1)]
ODO_GRID = [(15, 2), (15, 5), (8, 4)]


def submap_sizes(inputs):
    """(corner pad, surf pad, live corner, live surf) of the submap."""
    _, _, _, _, _, sub_c, sub_cm, sub_s, sub_sm = inputs
    return (sub_c.shape[0], sub_s.shape[0], int(sub_cm.sum()),
            int(sub_sm.sum()))


def part_steps(cfg, inputs):
    """(name, fn(carry, _) -> carry, extra) of the four parts."""
    m = cfg.mapping
    T0, c, cm, surf_q, surf_qm, sub_c, sub_cm, sub_s, sub_sm = inputs
    c, cm = compact(c, cm, c.shape[0])
    surf_q, surf_qm = compact(surf_q, surf_qm, surf_q.shape[0])
    qcnt_c = cm.sum(dtype=torch.int32).reshape(1)
    qcnt_s = surf_qm.sum(dtype=torch.int32).reshape(1)
    knn_c = mapping._make_knn5(sub_c, sub_cm, m)
    knn_s = mapping._make_knn5(sub_s, sub_sm, m)

    def query(q, carry):
        # A sum over padded neighbours may be inf: 0 * inf would be NaN.
        return mapping._transform(
            T0, q + 0.0 * torch.nan_to_num(carry, 0.0, 0.0, 0.0))

    def knn_surf(carry, _):
        return knn_s(query(surf_q, carry), qcnt_s)[1].sum()

    def knn_corner(carry, _):
        return knn_c(query(c, carry), qcnt_c)[1].sum()

    def surf_geometry(carry, _):
        nu, _, _ = mapping._surf_geometry(query(surf_q, carry), sub_s, knn_s,
                                          qcnt_s, m)
        return nu.sum()

    def corner_geometry(carry, _):
        a, _, _ = mapping._corner_geometry(query(c, carry), sub_c, knn_c,
                                           qcnt_c, m)
        return a.sum()

    qs, qc = f"{surf_q.shape[0]} x {sub_s.shape[0]}", \
        f"{c.shape[0]} x {sub_c.shape[0]}"
    return [(f"knn surf ({qs})", knn_surf, dict(part="knn surf")),
            (f"knn corner ({qc})", knn_corner, dict(part="knn corner")),
            ("surf geometry (knn+gather+fit)", surf_geometry,
             dict(part="surf geometry")),
            ("corner geometry (knn+gather+eig)", corner_geometry,
             dict(part="corner geometry"))]


def run(cfg, scans, valids, device, card, map_grid=MAP_GRID,
        odo_grid=ODO_GRID, n=profile_iters.N, reps=profile_iters.REPS,
        profile=True, engine=None):
    """Prints the submap sizes and every row; returns (sizes, part rows,
    scan_to_map rows, odometry rows).  ``engine``: a warm engine to take
    the state from (default: one driven over the scans)."""
    if engine is None:
        engine = profile_iters.warm_engine(cfg, scans, valids, device)
    inputs = profile_iters.map_inputs(engine.config, engine)
    sizes = submap_sizes(inputs)
    print(f"submap sizes: corner pad {sizes[0]} surf pad {sizes[1]} live "
          f"corner {sizes[2]} live surf {sizes[3]} [{card}]", flush=True)
    zero = torch.zeros((), device=device)
    part_rows = profile_iters.time_steps(
        part_steps(engine.config, inputs), zero, [()] * n, device, reps,
        profile)
    profile_iters.print_rows(part_rows, card)
    map_rows = profile_iters.mapping_grid(engine.config, inputs, device,
                                          map_grid, n, reps, profile)
    profile_iters.print_rows(map_rows, card)
    feats = profile_iters.features(cfg, scans, valids, device)
    odo_rows = profile_iters.odometry_grid(cfg, feats, device, odo_grid,
                                           reps, profile)
    profile_iters.print_rows(odo_rows, card)
    return sizes, part_rows, map_rows, odo_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    card = bench.card_line(device)
    cfg = synthetic_config()
    scans, valids, _ = profile_iters.make_scans(cfg)
    run(cfg, scans, valids, device, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
