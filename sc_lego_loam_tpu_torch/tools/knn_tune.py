"""Sweep the CUDA k-NN's compile-time tunables and its number of target
splits on one card, at the main path's three shapes.

    python -m sc_lego_loam_tpu_torch.tools.knn_tune \\
        --variants ";K5_R=4,K5_MINB=5;K5_U=8" --splits 12,44,64 \\
        [--profile] [--gate-scale 0] [--sass out_dir] [--json out.json]

Each variant is one build of ``csrc/knn.cu`` with ``-DKNN_<name>=<value>``
(see the tunables at the top of the source; an empty variant is the
source's defaults), built side by side.  Per variant, shape and S: every
output is held equal, bit for bit, to the first one computed (and that one
to the plain version on untied slots), then the call is timed on the
device (CUDA events around a replayed CUDA graph of ``--reps`` calls).
``ptxas`` registers and spills are printed per build; ``--profile`` adds
each kernel's device time per call, ``--gate-scale 0`` times the distance
loop alone (nothing is ever in range), ``--sass`` writes ``cuobjdump
-sass`` of each build there.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import cuda_knn, knn as plain_knn

# (name, k, queries, targets, max_sq_dist): scan-to-map 5-NN at the surf and
# corner submap pads of default_config(), ICP 1-NN at its pads.
SHAPES = [
    ("s2m_surf_k5", 5, 12288, 65536, 4.0),
    ("s2m_corner_k5", 5, 2048, 16384, 4.0),
    ("icp_k1", 1, 8192, 32768, 64.0),
]
TIE_REL = 1e-5


def uniform_cloud(seed, Q, T, valid=0.5, live=0.9):
    """Uniform points in a 40 x 40 x 4 m box on the card; ``valid`` of the
    targets and the first ``live`` of the queries count."""
    rng = np.random.default_rng(seed)
    box = np.array([20.0, 20.0, 2.0], np.float32)
    q = torch.from_numpy(rng.uniform(-box, box, (Q, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-box, box, (T, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random(T) < valid)
    qcnt = torch.full((1,), int(live * Q), dtype=torch.int32)
    return q.cuda(), t.cuda(), mask.cuda(), qcnt.cuda()


def graph_ms(fn, reps, replays=3):
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in one
    CUDA graph (so no host time between launches counts), the graph
    replayed ``replays`` times between CUDA events, the least taken."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def kernel_times_us(fn, reps=10):
    """Mean device microseconds per kernel name over ``reps`` calls
    (``torch.profiler``), and the SM clock ``nvidia-smi`` reads just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = "merge" if "knn_merge" in e.key else \
                "partial" if "knn_partial" in e.key else e.key[:40]
            times[name] = e.self_device_time_total / e.count
    return times, clock


def untied_equal(idx, sqd, ref_idx, ref_sqd, k, max_sq):
    """Kernel (k slots) against the plain version's k+1 slots: distances
    within 1e-4, indices equal where no neighbouring slot is tied."""
    d = ref_sqd.double()
    gap = d.abs().clamp(min=1e-12) * TIE_REL
    found = d < max_sq
    tied_next = ((d[:, 1:] - d[:, :-1]).abs() <= gap[:, :-1]) & found[:, :-1]
    tied = tied_next.clone()
    tied[:, 1:] |= tied_next[:, :-1]
    edge = d[:, :k]
    tied |= ((edge - max_sq).abs() <= gap[:, :k]) & (edge != max_sq)
    return bool((sqd - ref_sqd[:, :k]).abs().max() <= 1e-4) and \
        bool((idx[~tied] == ref_idx[:, :k][~tied]).all())


def ptxas_lines(log):
    """(function, registers, spill stores, spill loads) per kernel."""
    out, name = [], None
    spill = (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="",
                    help="';'-separated builds, each 'NAME=V,NAME=V'")
    ap.add_argument("--splits", default="1,2,4,8,16,32,64")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--gate-scale", type=float, default=1.0,
                    help="multiply every shape's max_sq_dist (0: nothing "
                         "is ever in range, the distance loop alone)")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also print each kernel's device time per call")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    variants = [tuple(f"-DKNN_{d}" for d in v.split(",") if d)
                for v in args.variants.split(";")]
    splits = [int(s) for s in args.splits.split(",")]

    with ThreadPoolExecutor(len(variants)) as pool:
        infos = list(pool.map(cuda_knn.compile_library, variants))
    libs = []
    for defines, info in zip(variants, infos):
        lib, configs = cuda_knn.load_library(info.path)
        libs.append((defines, lib, configs))
        print(f"build {' '.join(defines) or '(defaults)'}: "
              f"{info.seconds:.1f} s, {configs}")
        for name, regs, st, ld in ptxas_lines(info.log):
            print(f"  ptxas {name}: {regs} registers, spill {st}/{ld} bytes")
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            tag = "_".join(d[6:] for d in defines) or "defaults"
            sass = subprocess.run(["cuobjdump", "-sass", info.path],
                                  capture_output=True, text=True).stdout
            with open(os.path.join(args.sass, f"knn_{tag}.sass"), "w") as f:
                f.write(sass)

    rows = []
    for seed, (name, k, Q, T, max_sq) in enumerate(SHAPES):
        max_sq *= args.gate_scale
        q, t, mask, qcnt = uniform_cloud(seed, Q, T)
        prep = cuda_knn.prepare_targets(t, mask)
        one = cuda_knn.PreparedTargets(prep.tgt[None], prep.cnt,
                                       prep.perm[None])
        ref = None
        for defines, lib, configs in libs:
            for S in splits:
                call = lambda: cuda_knn.launch_with(   # noqa: E731
                    lib, q[None], one, k, max_sq, qcnt, S)
                idx, sqd = (x[0] for x in call())
                torch.cuda.synchronize()
                if ref is None:
                    pi, pd = plain_knn.knn(q, t, mask, k + 1, max_sq, qcnt)
                    if not untied_equal(idx, sqd, pi, pd, k, max_sq):
                        print(f"FAILED: {name} differs from the plain version")
                        return 1
                    ref = (idx, sqd)
                same = torch.equal(idx, ref[0]) and torch.equal(sqd, ref[1])
                ms = graph_ms(call, args.reps)
                cfg = configs[k]
                tiles = -(-Q // (cfg.threads * cfg.R))
                rows.append(dict(shape=name, defines=" ".join(defines), S=S,
                                 R=cfg.R, U=cfg.U, threads=cfg.threads,
                                 blocks=tiles * S, ms=ms, equal=same))
                print(f"{name} {' '.join(defines) or '(defaults)'} S={S} "
                      f"R={cfg.R} U={cfg.U} threads={cfg.threads} "
                      f"blocks={tiles * S} ms={ms:.4f} equal={same} [{card}]",
                      flush=True)
                if args.profile:
                    times, clock = kernel_times_us(call)
                    print("  kernels (us): " + ", ".join(
                        f"{n} {t:.2f}" for n, t in sorted(times.items()))
                        + f"; clocks.sm just after: {clock}", flush=True)
                if not same:
                    print("FAILED: output differs from the first variant's")
                    return 1
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
