"""Iteration-cost decomposition of the odometry and scan-to-map LM loops
(the counterpart of the JAX package's ``tools/profile_iters.py``).

    python -m sc_lego_loam_tpu_torch.tools.profile_iters [--device cuda]

Times ``odometry.step`` over a (max_iterations, research_every) grid with
the convergence deltas zeroed, then ``mapping.scan_to_map`` over a grid on
the state of an engine warmed on the same 8 scans: the slope in
iterations is the per-iteration solve cost, the slope in researches the
per-research correspondence cost, the intercept the fixed cost (a
least-squares fit over each grid prints after it).  Inputs: 8 scans of
``synthetic_config()``'s figure-8 (radius 30 m, 0.1 laps, noise 0.01,
seed 11, beam order).

Each row is per call (per scan), the state carried from call to call as
the JAX tool's ``lax.scan`` carries it:

- ``device_ms``: CUDA events around replays of a captured graph of the
  step (``graphs.StepGraph``, what ``SlamEngine`` replays), 3 passes over
  the 8 inputs; the distinct feature sets reach the graph through its
  static inputs, and that copy-in is timed apart (``copy_ms``);
- ``host_ms``: the eager step on the host clock, one pass, a synchronize
  closing the window;
- ``launches`` / ``kernel_ms``: the device kernels of one eager call and
  their summed time, from one ``torch.profiler`` session opened after
  every timing (``profile_stages.profile_launches``);
- ``knn_k5``: CUDA kNN calls (k=5) of one eager call (``cuda_knn.launches``).

The port's LM runs every iteration whatever the deltas (a converged state
is frozen with ``torch.where``, not skipped), so zeroing them changes no
cost here; the rows keep the JAX tool's setting.  ``--device`` defaults to
``cuda`` and fails without a card; on the CPU only ``host_ms`` is
measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import frontend, graphs, mapping, odometry, pipeline
from ..config import synthetic_config
from ..ops import cuda_knn
from ..pipeline import SlamEngine
from . import bench, profile_stages

N = 8                 # scans: the inputs of one pass
SEED = 11
REPS = 3              # graph passes over the N inputs
ODO_GRID = [(15, 2), (15, 5), (15, 15), (8, 2), (8, 4), (8, 8), (4, 2),
            (4, 4), (2, 2), (1, 1)]
MAP_GRID = [(8, 3), (8, 8), (8, 1), (4, 2), (4, 4), (2, 2), (1, 1)]


def make_scans(cfg, n=N, seed=SEED):
    """The tool's drive: the figure-8's first tenth of a lap over ``n``
    scans, rays cast in worker processes (``bench.get_sequence``)."""
    return bench.get_sequence(cfg.lidar, n, trajectory="figure8",
                              radius=30.0, loops=0.1, noise=0.01, seed=seed,
                              shuffle=False)


def features(cfg, scans, valids, device):
    """Each scan's feature set (frontend -> features, as the JAX tool: no
    de-skew), on ``device``."""
    out = []
    for pts, msk in zip(scans, valids):
        fo = frontend.run(cfg, torch.as_tensor(pts, device=device),
                          torch.as_tensor(msk, device=device))
        fs, _, _ = pipeline._extract(cfg, fo.cloud, fo.outlier)
        out.append(fs)
    return out


def odo_config(base, it, re):
    return base.replace(odom=dataclasses.replace(
        base.odom, max_iterations=it, research_every=re, delta_rot_deg=0.0,
        delta_trans_cm=0.0))


def map_config(base, it, re):
    return base.replace(mapping=dataclasses.replace(
        base.mapping, max_iterations=it, research_every=re,
        delta_rot_deg=0.0, delta_trans_cm=0.0))


def researches(it, re):
    """Correspondence searches of an LM of ``it`` iterations re-searching
    every ``re``-th: the initial one, then at every it' % re == 0."""
    return 1 + sum(1 for i in range(1, it) if i % re == 0)


def _tensors(x):
    return [t for t in graphs.flatten(x) if isinstance(t, torch.Tensor)]


def graph_chain_ms(fn, state0, inputs, device, reps=REPS, name="step"):
    """(device ms, copy-in ms) per call of ``fn(state, x) -> state`` over
    ``inputs``, the state carried: a ``StepGraph`` of ``fn`` (its first
    call the warm-up, its second the capture), then ``reps`` passes, each
    loading ``state0`` and, per input, copying it into the static inputs
    and replaying, between CUDA events.  None on the CPU."""
    if torch.device(device).type != "cuda":
        return None, None
    g = graphs.StepGraph(lambda st, x: (fn(st, x),),
                         graphs.CudaCapture(device), name)
    # The capture adopts the state and inputs it is given as its static
    # buffers: hand it copies.
    (st,) = g(pipeline._own(state0, device), inputs[0])
    g(st, pipeline._own(inputs[1 % len(inputs)], device))
    dsts = g.static_inputs
    marks = []
    for _ in range(reps):
        g.load(state0)
        for x in inputs:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            graphs.write(dsts, _tensors(x))
            ev[1].record()
            g.replay()
            ev[2].record()
            marks.append(ev)
    bench.sync(device)
    n = len(marks)
    return (sum(e[1].elapsed_time(e[2]) for e in marks) / n,
            sum(e[0].elapsed_time(e[1]) for e in marks) / n)


def host_chain_ms(fn, state0, inputs, device):
    """(host ms per call of the eager ``fn`` over ``inputs``, the state
    carried and a synchronize closing the window; k=5 kNN calls per call)."""
    fn(state0, inputs[0])
    bench.sync(device)
    k5 = cuda_knn.launches[5]
    st = state0
    t0 = time.perf_counter()
    for x in inputs:
        st = fn(st, x)
    bench.sync(device)
    n = len(inputs)
    return 1e3 * (time.perf_counter() - t0) / n, \
        (cuda_knn.launches[5] - k5) / n


def time_steps(steps, state0, inputs, device, reps=REPS, profile=True):
    """One row per (name, fn, extra) of ``steps``, ``fn(state, x) ->
    state`` carried over ``inputs`` from ``state0`` (``extra``: more keys
    of the row).  The launches of every step come from one profiler
    session after all the timings (``profile``)."""
    rows = []
    for name, fn, extra in steps:
        dev_ms, copy_ms = graph_chain_ms(fn, state0, inputs, device, reps,
                                         name)
        host_ms, k5 = host_chain_ms(fn, state0, inputs, device)
        rows.append(dict(name=name, device_ms=dev_ms, copy_ms=copy_ms,
                         host_ms=host_ms, knn_k5=k5, launches=None,
                         kernel_ms=None, **extra))
    if profile:
        fns = [(lambda fn=fn: fn(state0, inputs[0])) for _, fn, _ in steps]
        got = profile_stages.profile_launches(fns, device)
        for r, (launches, kernel_ms) in zip(rows, got or ()):
            r["launches"], r["kernel_ms"] = launches, kernel_ms
    return rows


def time_grid(label, make_fn, grid, state0, inputs, device, reps=REPS,
              profile=True):
    """``time_steps`` over the (it, re) of ``grid``: ``make_fn(it, re)`` is
    the step."""
    return time_steps(
        [(f"{label} it={it} re={re}", make_fn(it, re),
          dict(it=it, re=re, researches=researches(it, re)))
         for it, re in grid], state0, inputs, device, reps, profile)


def num(x, fmt=".3f"):
    return "n/a" if x is None else format(x, fmt)


def print_rows(rows, card):
    for r in rows:
        print(f"{r['name']:36s} device_ms={num(r['device_ms'])} "
              f"copy_ms={num(r['copy_ms'])} host_ms={r['host_ms']:.3f} "
              f"launches={num(r['launches'], 'd')} "
              f"kernel_ms={num(r['kernel_ms'])} knn_k5={r['knn_k5']:g} "
              f"ms/scan [{card}]", flush=True)


def fit(rows, key):
    """Least squares of ``key`` = fixed + per_iteration * it +
    per_research * researches over the rows; None when a value is missing
    or the grid cannot separate the three terms."""
    y = [r[key] for r in rows]
    if any(v is None for v in y):
        return None
    A = np.array([[1.0, r["it"], r["researches"]] for r in rows])
    if np.linalg.matrix_rank(A) < 3:
        return None
    coef, *_ = np.linalg.lstsq(A, np.asarray(y, float), rcond=None)
    return dict(zip(("fixed", "per_iteration", "per_research"),
                    (float(c) for c in coef)))


def print_fits(label, rows, card):
    """The decomposition of every measured column of ``rows``."""
    for key in ("device_ms", "host_ms", "launches", "kernel_ms"):
        f = fit(rows, key)
        if f is not None:
            print(f"fit {label} {key}: fixed={f['fixed']:.4f} "
                  f"per_iteration={f['per_iteration']:.4f} "
                  f"per_research={f['per_research']:.4f} [{card}]",
                  flush=True)


def odometry_grid(base, feats, device, grid=ODO_GRID, reps=REPS,
                  profile=True):
    """``odometry.step`` over ``grid`` from the initial state, carried over
    the feature sets ``feats``."""
    state0 = odometry.init_state(base, device)

    def make_fn(it, re):
        cfg = odo_config(base, it, re)
        return lambda st, fs: odometry.step(cfg, st, fs)[0]

    return time_grid("odometry", make_fn, grid, state0, feats, device, reps,
                     profile)


def warm_engine(cfg, scans, valids, device):
    """An engine over the scans (the JAX tool's warm 8-scan state)."""
    engine = SlamEngine(cfg, device=device)
    for i in range(len(scans)):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    bench.sync(device)
    return engine


def map_inputs(cfg, engine):
    """What scan_to_map reads on ``engine``'s state, as the JAX tools build
    it: the submap of its keyframes, and the last scan's features
    downsampled with an empty outlier list (surf queries = surf +
    outliers).  Returns (T0, corner, corner mask, surf, surf mask, submap
    corner, its mask, submap surf, its mask)."""
    dev = engine.device
    odo = engine.p.odo
    sub = mapping.build_submap(cfg, engine.m.kf)
    c, cm, s, sm, o, om = mapping.downsample_scan(
        cfg, odo.corner_last.xyz, odo.corner_last.mask, odo.surf_last.xyz,
        odo.surf_last.mask,
        torch.zeros((cfg.cap.outlier_pad, 3), device=dev),
        torch.zeros((cfg.cap.outlier_pad,), dtype=torch.bool, device=dev))
    return (engine.m.pose.clone(), c, cm, torch.cat([s, o]),
            torch.cat([sm, om]), *sub)


def mapping_grid(base, inputs, device, grid=MAP_GRID, n=N, reps=REPS,
                 profile=True):
    """``mapping.scan_to_map`` over ``grid``, the pose carried over ``n``
    calls on the same scan and submap (``map_inputs``)."""
    T0, *rest = inputs

    def make_fn(it, re):
        cfg = map_config(base, it, re)
        return lambda T, _: mapping.scan_to_map(cfg, T, *rest)

    return time_grid("scan_to_map", make_fn, grid, T0, [()] * n, device,
                     reps, profile)


def run(base, scans, valids, device, card, odo_grid=ODO_GRID,
        map_grid=MAP_GRID, reps=REPS, profile=True, engine=None):
    """Both grids and their fits, printed; returns (odometry rows, mapping
    rows).  ``engine``: a warm engine to take the mapping inputs from
    (default: one driven over the scans)."""
    feats = features(base, scans, valids, device)
    odo_rows = odometry_grid(base, feats, device, odo_grid, reps, profile)
    print_rows(odo_rows, card)
    print_fits("odometry", odo_rows, card)
    if engine is None:
        engine = warm_engine(base, scans, valids, device)
    map_rows = mapping_grid(engine.config, map_inputs(engine.config, engine),
                            device, map_grid, len(scans), reps, profile)
    print_rows(map_rows, card)
    print_fits("scan_to_map", map_rows, card)
    return odo_rows, map_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = bench.require_device(ap.parse_args(argv).device)
    card = bench.card_line(device)
    cfg = synthetic_config()
    scans, valids, _ = make_scans(cfg)
    print(f"profile_iters: {N} scans of synthetic_config's figure-8 "
          f"(seed {SEED}) [{card}]", flush=True)
    run(cfg, scans, valids, device, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
