#!/usr/bin/env python3
"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py [--drive cloverleaf]

Phases, each printing its own lines:

1. device: torch/CUDA versions and the card's name and power limit;
2. data: the bench's headline drive (motion-skewed OS1-64 figure-8, 240
   scans) from the port's own generator, rays cast in worker processes;
3. build: compile the hand-written CUDA kNN (``csrc/knn.cu``) from the
   checkout and load it;
4. kernel vs plain version: the kernel and ``ops/knn.py`` on the same
   tensors on the card, at the main paths' shapes (scan-to-map 5-NN, corner
   and surf; ICP 1-NN), with the launch plan (splits S, R, U, blocks, device
   kernels per call), timed on the device (CUDA events around a replayed
   CUDA graph of 20 calls), beside the least time the card could take for
   the same work and beside ``torch.cdist`` + ``topk`` (not the same
   function); then the tie rule across splits and tiles and the smallest
   target counts (0, 1, fewer than S);
   and ``cuda_knn.prepare_targets`` (torch ops) at the callers' pads beside
   its bound in bytes;
5. slice: ``SlamEngine(cfg, device="cuda")`` with loop closure off over the
   first scans of the drive; then the same slice with the reference's
   two-stage 3-DOF odometry (``joint_6dof=False``, sparse pick sets);
6. loop path: ``SlamEngine(default_config())`` on the card, loop closure
   on, over the whole drive: Scan Context retrieval, ICP through the kernel
   at k=1, pose-graph re-solve; kNN launches per k, accepted loop factors
   against ground truth, ATE, scans/s, peak memory, and the host syncs of
   loop ticks apart from the rest;
7. IMU path: ``imu.enabled`` and the bench's synthesized 100 Hz IMU
   stream, one ``push_imu_batch`` a scan (IMU de-skew, rotation prior, roll
   / pitch blend), over the drive's first 120 scans (a depth cut for the
   time limit: no revisit yet, so no loop may close);
8. runner and export: the drive's first scans written as a MulRan-layout
   directory and run through ``runner.run_mulran`` (native loader built
   with g++); the loop path's end state through ``save_checkpoint`` /
   ``load_checkpoint`` into a fresh engine, every field equal, and one
   mapping + loop step of the resumed engine against the original's;
9. IMU parts and loop tick breakdown: what the IMU adds to a scan
   (``push_imu_batch``, the de-skew of both grids, the prior, the blend) and
   the parts of one loop tick (retrieval, radius detection, history submap,
   keyframe cloud, ICP, one verification, the re-solve), each with its
   synchronized time, its kernel launches and its host syncs;
10. real clouds: the kernel against the plain version, timed as in 4, on
   the loop path's own clouds: k=5 on the submap the last keyframe was
   matched against, queried with that keyframe's downsampled corner and
   surf features at its pose; k=1 on phase 9's keyframe cloud and history
   submap.

The multi-sequence batch (``parallel/batch.py``) adds, in their places:
the kernel's batch axis in phase 4 (B items in one call against B single
calls, equal in every slot, and against the plain version: B=3 at the
scan-to-map shapes and the ICP's, B=8 at the ICP's with an item of no valid
target; timed beside B single calls); after phase 7 the BATCH PATH,
``BatchEngine(default_config(), n_seq=3)`` over three 240-scan windows
(scans 0, 40, 80) of a 320-scan skewed figure-8 over 1.6 laps (each
window drives its first 48 scans again), with loop closure on
(aggregate sequence-scans/s beside the loop path's, per-sequence ATE, loops
and factors, syncs by place, functorch per-sample fallbacks by stage), and
the MERGE (``find_cross_loops`` + ``verify_cross_loops`` for pairs (0, 1)
and (0, 2), ``anchor_sequence``, one ``merge_solve`` of the three chains,
placement errors against ground truth); after phase 10 the kernel launches
of one batched step beside the single-sequence functions'.

``--drive cloverleaf`` swaps the figure-8 for the bench's loop precision /
recall drive (520 scans, four petals through one centre, three revisit
events): the same phases and checks over a path that accepts many factors.

The mesh paths (``parallel/mesh.py``, ``parallel/retrieval.py``, the
``mesh`` arguments) come after the merge.  The machine has one card, so:
M1 is ``SlamEngine(default_config(), mesh=make_mesh(1, 1))`` in this
process on NCCL at world size 1 over the drive's first 32 scans, held
against the loop path's first poses within the card's run-to-run spread
(a second plain run), and it runs while M2's processes drive (for the
time limit); M2 is two processes on the one card, joined by gloo
on CUDA tensors with a 'kf' mesh of 2, each driving the sharded
``SlamEngine(default_config())`` over the whole drive with half of the
banks (gates against the loop path's single engine: keyframes within 2,
the same ``loops_closed``, every factor true, ATE below max(2 x, + 0.15 m)
of its), then sharded retrieval and the sharded re-solve on the engine's
own banks against their unsharded forms; M3 is two processes with a 'seq'
mesh of 2, ``BatchEngine(default_config(), n_seq=2)`` one sequence a
rank over the batch drive's first 12 steps, against one process's
``BatchEngine(n_seq=1)`` over each sequence (a rank's own work: within
twice the run-to-run spread, 0.05 m / 0.5 deg at least) and its
``BatchEngine(n_seq=2)`` (another batch size: within 0.14 m / 0.75 deg,
ATE as in M2).  A rank that fails fails the script.

The launch layer (``tools/bench.py``, ``tools/run_capacity.py``,
``tools/profile_stages.py``) adds: in phase 4 the kernel at the pads of
``vlp16_config()`` (the 16-beam sensor); after the runner the ORDERED PATH,
``synthetic_config()`` (beam-ordered scans, reshape projection, no de-skew,
loop closure on) over the first 96 scans of the bench's ordered figure-8
(seed 11; rays cast in the background while phase 4 runs) through
``tools.bench.run_engine`` (ATE, k=5 launches, no sync outside loop ticks
but the ``eigh``); LATENCY, ``tools.bench.latency_ms`` over the loop
drive's first 6 + 24 scans (p50 / p95 / p99 / max); the CAPACITY RUNWAY's
card part (``tools.run_capacity``: the tiny engine at 16,384 keyframes with
16 scans past the cap, then a second full-size state filled to 16,384
keyframes from the loop path's, one mapping and one loop step over it, the
loop bank past its 256 slots and one re-solve; every check a gate, the
state freed after); and last, ``tools.profile_stages`` on the loop path's
end state (synchronized, device and host ms, launches and syncs of every
sub-stage).  An ``elapsed:`` line follows each phase.

One dispatch a step (``graphs.py``): every ``SlamEngine`` above runs its
``perception_step`` and ``mapping_step`` as CUDA graph replays (the
default on the card; ``eager=True`` is the op-by-op path), and the
degeneracy guard's ``eigh`` and the ICP fit's ``svd`` are the hand-written
``csrc/symeig.cu`` (Horn's quaternion method for the fit), so a path reads
no device value outside its loop ticks: the sync gates allow none.  In
phase 4 the SYMEIG kernel (one warp a matrix, parallel-ordered Jacobi;
ptxas must report no spill and no stack frame for it) against its plain
version (``torch.linalg.eigh`` on CPU copies) at B = 1, 3 and 16 for n =
3, 4, 6 and on 4096 random SPD 6x6 matrices with condition numbers up to
1e8 (eigenvalues, reconstruction, orthogonality, the degeneracy projector
and its flag); on repeated eigenvalues (each eigenspace's projector), a
diagonal matrix (no sweep, the sorted diagonal exactly) and the
indefinite 4x4 Horn matrices of a real ICP fit between two scans of the
drive (and that fit's rotation against the same fit on the CPU); each
shape timed beside an empty kernel's launch floor (``floor_ms``), the
bound and, at B=1, ``torch.linalg.eigh`` on the card.  After the loop path,
REPEATABLE: two eager engines over the loop drive's first 32 scans must
agree bit for bit, and a graphed engine with them (and with the loop
path's first published poses); the graphs' nodes, capture time and pool
memory print; then 12 eager scans under
``torch.use_deterministic_algorithms(True, warn_only=True)`` list what
torch still calls nondeterministic.

Every step at one dispatch (``graphs.cond``): the loop tick is a third
graph whose gates are CUDA-graph conditional nodes, so the loop path's,
the IMU path's and the ordered path's sync gates cover the whole timed
window, loop ticks included (the captures' own syncs tagged), and the
loop ticks' replays print by outcome in CUDA-event and host ms.  After the
loop path, the CLOSING TICK: its last closing tick again from the state
going into it (per-tick copies of the small leaves, the end state's banks
with later rows reset), eager and graphed, bit for bit equal to each
other and to the path's own tick; the CLOSING-WINDOW LATENCY: a fresh
graphed engine over the whole drive, a synchronize after every scan, p50
/ p95 / p99 / max and each tick outcome's latency.  The tracer
(``utils/profiling.py``, ``graphs.probe``) adds: in phase 4 the PROBE
kernel timed in a graph with its on-flag off and on beside the empty
kernel; after the closing tick, the PROBE RECORDS of the loop path's
graphs (tracing on for the whole drive) against the plain version, the
CPU ``ProbeRing`` in an engine run through ``graphs.EagerStandIn`` over
the same scans, equal site for site and value for value in every scan,
a closing tick among them.  After the repeatable
phase, the BATCH at S = 8 and 16 (graphed, windows spread over scans 0-80
of the batch drive, one engine at a time, each freed before the next);
the batch path at S = 3 is graphed, and an eager S = 3 batch runs behind
M2 and is compared with it (the same loops, trajectories bit-equal or
within 5 mm).  Every path warms up 16 scans (the bench's).

After the capacity runway, the DIAGNOSTICS: the 11 tools of
``sc_lego_loam_tpu_torch/tools/`` that take the engine apart
(``profile_iters``, ``profile_odo``, ``profile_s2m``, ``tune_research``,
``diag_loops``, ``diag_real``, ``debug_fig8``, ``diag_tiny``,
``profile_micro``, ``profile_latency``, ``profile_engine2``) through their
functions at a reduced depth, on the ordered drive, the loop drive and the
loop path's end state (the tiny configuration's drives cast here); every
CUDA-event time finite and > 0, one k=5 call a call of each kNN part, two a
research of ``scan_to_map``, and ``diag_loops`` over the loop path's drive
closing its loops with true factors and a bit-equal trajectory; their kNN
and symeig launches count under the path name "diagnostics".

It fails (non-zero exit, no ``ok`` line) when there is no card or any
check fails.  The second-to-last line is the kernel summary, the last the
``ok`` object.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import gc
import json
import os
import re
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch

from sc_lego_loam_tpu_torch import (graphs, imu as imu_mod, loop, mapping,
                                    pipeline, posegraph, runner)
from sc_lego_loam_tpu_torch.config import (ImuConfig, default_config,
                                           synthetic_config,
                                           tiny_test_config, vlp16_config)
from sc_lego_loam_tpu_torch.models import scan_context
from sc_lego_loam_tpu_torch.ops import (cuda_knn, icp, knn as plain_knn,
                                        solver, symeig)
from sc_lego_loam_tpu_torch.ops.compact import compact
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.tools import (bench, debug_fig8, diag_loops,
                                          diag_real, diag_tiny,
                                          profile_engine2, profile_iters,
                                          profile_latency, profile_micro,
                                          profile_odo, profile_s2m,
                                          profile_stages, run_capacity,
                                          tune_research)
from sc_lego_loam_tpu_torch.tools.knn_tune import (graph_ms, ptxas_lines,
                                                   uniform_cloud)
from sc_lego_loam_tpu_torch.tools.symeig_ab import spd_batch
from sc_lego_loam_tpu_torch.utils import (evaluate, export, native_io, se3,
                                          synthetic)

KNN_SOURCE = "sc_lego_loam_tpu_torch/csrc/knn.cu"
KNN_REPLACES = "sc_lego_loam_tpu/ops/pallas_knn.py:146"
# symeig replaces no Pallas kernel: jnp.linalg.eigh inside the jitted steps.
SYMEIG_SOURCE = "sc_lego_loam_tpu_torch/csrc/symeig.cu"
SYMEIG_REPLACES = "sc_lego_loam_tpu/ops/solver.py:156"



def knn_shapes(cfg, prefix=""):
    """(name, k, queries, targets, max_sq_dist) of the kernel's calls at
    ``cfg``'s pads: the scan-to-map 5-NN, surf (a keyframe's surf + outlier
    pads against the surf submap's) and corner, and the ICP 1-NN (its query
    pad against the history submap's)."""
    cap, s2m_sq = cfg.cap, 4.0 * cfg.mapping.max_nn_sq_dist
    return [
        (prefix + "s2m_surf_k5", 5, cap.kf_surf_pad + cap.kf_outlier_pad,
         cap.submap_surf_pad, s2m_sq),
        (prefix + "s2m_corner_k5", 5, cap.kf_corner_pad,
         cap.submap_corner_pad, s2m_sq),
        (prefix + "icp_k1", 1, cap.icp_query_pad, cap.history_pad,
         icp.NN_MAX_SQ_DIST),
    ]


# default_config(): 12288 x 65536, 2048 x 16384, 8192 x 32768; the 16-beam
# vlp16_config() (BASELINE.json config 5): 6144 x 32768, 1024 x 8192,
# 4096 x 16384.
SHAPES = knn_shapes(default_config())
VLP16_SHAPES = knn_shapes(vlp16_config(), "vlp16_")
TIE_REL = 1e-5        # slots this close to a neighbour's distance are ties
SQD_ATOL = 1e-4
GRAPH_CALLS = 20      # kernel calls captured in the graph that is timed

# Published peaks of one H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# One pair distance: 3 subtractions, a multiply, two FMAs (2 each) and the
# compare against the current k-th best.
FLOPS_PER_PAIR = 9

# name -> (scans, (trajectory, its arguments)): the bench's headline drive
# (bench.py _real_sequence) and its loop precision / recall drive
# (bench.py block_clover_real); both noise 0.01, seed 11, motion-skewed,
# capture order.
DRIVES = {
    "figure8": (240, (synthetic.figure8_trajectory,
                      dict(radius=30.0, loops=1.05))),
    "cloverleaf": (520, (synthetic.cloverleaf_trajectory,
                         dict(radius=32.0, petals=4))),
}
LOOP_WARMUP = 16      # the bench's: the three graphs are captured in it
ORDERED_SCANS = 96    # ordered path: its drive's first scans (no revisit)
LATENCY_SCANS = 24    # latency: timed scans after the loop path's warm-up (time)
CAPACITY_EXTRA = 16   # capacity part 1: scans past the cap (the tool's 64)
PROFILE_REPS = 1      # profile_stages: calls a sub-stage timing (whole: 1)
IMU_SCANS = 120       # IMU path: the drive's first scans (no revisit yet)
SLICE_SCANS = 12      # loop-off slice: the drive's first scans
SLICE_WARMUP = 4
RUNNER_SCANS = 24     # scans written out for the MulRan runner
ATE_BAR = 1.0         # the verify recipe's PASS bar (m)
FACTOR_TOL_M = 1.0    # a loop factor is true within this of ground truth
# The only sync a path may show outside its loop ticks: the watch's own
# switch back to the default mode (torch/cuda/__init__.py).
SYNC_FILES = ("torch/cuda/__init__.py",)
SYMEIG_TOL = 1e-5     # eigenvalues (x max|lambda|), reconstruction,
                      # orthogonality and projectors, against the plain
SYMEIG_BATCH = 4096   # the conditioned batch: random SPD 6x6, condition
SYMEIG_COND = 1e8     # numbers log-uniform up to this
SYMEIG_SIZES = (3, 4, 6)      # the two-stage LM, Horn's fit, the joint LM
SYMEIG_BATCHES = (1, 3, 16)   # one engine; BatchEngine's vmapped calls
SYMEIG_MAX_SWEEPS = 20        # the kernel's cap (kMaxSweeps)
HORN_SCANS = (0, 4)           # the ICP fit of the Horn check: scan 4 onto 0
REPEAT_SCANS = 32     # repeatable: the loop drive's first scans, 3 runs
DET_SCANS = 12        # ... and the deterministic-mode listing's
COPY_LIMIT = 1 << 20  # no leaf this large is copied into a graph per step
SMALL_LEAF = 4 << 20  # a loop tick's state leaves under this are cloned
                      # before every tick of the loop path (closing tick)
BATCH_SIZES = (3, 8, 16)   # sequences a card: windows of the batch drive
BATCH_FALLBACK = 12        # ... the largest tried if 16 does not fit
BATCH_EQUAL_M = 5e-3       # graphed against eager batch, if not bit-equal
K1_SLOT = graphs.SLOTS.index(("knn", 1))


def reset_counts():
    """Every kernel's launch count to 0 (the device counters of
    conditional bodies flushed first)."""
    graphs.flush_counts()
    cuda_knn.reset_launches()
    symeig.reset_launches()


def launch_counts() -> dict:
    """kNN calls by k (1, 5) and symeig launches ("symeig", all sizes),
    those counted on the device in conditional bodies included (one read
    of the counters)."""
    graphs.flush_counts()
    out = dict(cuda_knn.launches)
    out["symeig"] = sum(symeig.launches.values())
    return out


def free_memory():
    """Free what dropped engines held: a ``BatchEngine`` and its step
    graphs (bound methods) refer to each other, so only the cycle
    collector frees them; then the allocator's cache."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def k1_mark():
    """The k=1 kNN calls so far: the host count and a device copy of the
    conditional bodies' counter (no host read)."""
    return cuda_knn.launches[1], graphs.device_counter("cuda")[K1_SLOT].clone()


def k1_between(a, b) -> int:
    """k=1 calls between two marks (reads the device copies: after the
    timed window)."""
    return b[0] - a[0] + int(b[1]) - int(a[1])


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_to_plain(idx_t, sqd_t, q, t, mask, qcnt, k, max_sq):
    """The kernel's outputs against the plain version on the same tensors.
    Indices must agree in every slot whose distance is not tied (within
    TIE_REL) with a neighbouring slot's.  Returns (index mismatches, max
    |dsqd|, rows past qcnt empty, slots compared, slots in all)."""
    ref_idx, ref_sqd = plain_knn.knn(q, t, mask, k + 1, max_sq, qcnt)
    torch.cuda.synchronize()
    idx, sqd = idx_t.cpu().numpy(), sqd_t.cpu().numpy()
    ref_idx, ref_sqd = ref_idx.cpu().numpy(), ref_sqd.cpu().numpy()

    err = float(np.abs(sqd - ref_sqd[:, :k]).max())
    d = ref_sqd.astype(np.float64)
    gap = np.maximum(np.abs(d), 1e-12) * TIE_REL
    found = d < max_sq                    # an empty slot is never a tie
    tied_next = (np.abs(d[:, 1:] - d[:, :-1]) <= gap[:, :-1]) \
        & found[:, :-1]                                          # (Q,k)
    tied = tied_next.copy()
    tied[:, 1:] |= tied_next[:, :-1]
    edge = d[:, :k]                       # found just inside the range edge
    tied |= (np.abs(edge - max_sq) <= gap[:, :k]) & (edge != max_sq)
    compared = ~tied
    mismatch = int((idx[compared] != ref_idx[:, :k][compared]).sum())
    live = int(qcnt.item())
    dead_ok = bool((idx[live:] == 0).all() and (sqd[live:] == max_sq).all())
    return mismatch, err, dead_ok, int(compared.sum()), compared.size


def knn_bound(Q, T, k, live, tcnt):
    """The least time the card could take for one call: the live pairs'
    arithmetic at the fp32 peak, or every input read once (queries, the
    16-byte target records, the slot -> index map, the two counts) and
    every output written once (int64 index and fp32 distance per slot).
    Returns (bound ms, what binds, ops ms, bytes ms, pairs, bytes)."""
    pairs = live * tcnt
    moved = Q * 12 + T * 16 + T * 8 + 8 + Q * k * 12
    ops_ms = 1e3 * pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * moved / PEAK_BYTES_PER_S
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    return bound_ms, bound_by, ops_ms, bytes_ms, pairs, moved


def kernel_vs_plain(name, k, q, t, mask, qcnt, max_sq, card):
    """Kernel against the plain version on one set of tensors on the card
    (``compare_to_plain``), timed beside its bound."""
    Q, T = q.shape[0], t.shape[0]
    prep = cuda_knn.prepare_targets(t, mask)
    plan, cfg = cuda_knn.plan(k, Q, T, q.device), cuda_knn.kernel_config(k)
    idx_t, sqd_t = cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt)
    mismatch, err, dead_ok, n_compared, n_slots = compare_to_plain(
        idx_t, sqd_t, q, t, mask, qcnt, k, max_sq)
    live, tcnt = int(qcnt.item()), int(prep.cnt.item())
    bound_ms, bound_by, ops_ms, bytes_ms, pairs, moved = knn_bound(
        Q, T, k, live, tcnt)

    kern = lambda: cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt)  # noqa: E731
    plain = lambda: plain_knn.knn(q, t, mask, k, max_sq, qcnt)     # noqa: E731
    # torch.cdist + topk on the live queries and the compacted targets: no
    # range gate, no tie rule, distances by the norm expansion.  A yardstick
    # only; the port never calls it.
    ql, tl = q[:live], prep.tgt[:tcnt, :3].contiguous()
    cdist = lambda: torch.cdist(ql, tl).topk(min(k, tcnt), largest=False)  # noqa: E731
    p1 = time_ms(plain, 3)
    ms = graph_ms(kern, GRAPH_CALLS)
    eager_ms = time_ms(kern, GRAPH_CALLS)
    cdist_ms = time_ms(cdist, 3) if live and tcnt else float("nan")
    p2 = time_ms(plain, 3)
    plain_ms = (p1 + p2) / 2
    print(f"kernel {name}: k={k} Q={Q} T={T} valid_targets={tcnt} "
          f"qcnt={live} max_sq_dist={max_sq} "
          f"splits={plan.splits} R={cfg.R} U={cfg.U} threads={cfg.threads} "
          f"queue={cfg.queue} tile={cfg.tile} stages={cfg.stages} "
          f"blocks={plan.blocks} device_kernels_per_call={plan.kernels} "
          f"compared_slots={n_compared}/{n_slots} "
          f"idx_mismatch={mismatch} max_abs_err={err:.3e} "
          f"(atol {SQD_ATOL}) rows>=qcnt_empty={dead_ok} "
          f"ms={ms:.4f} (device, graph of {GRAPH_CALLS} calls) "
          f"eager_call_ms={eager_ms:.4f} (back to back, host included) "
          f"plain_ms={plain_ms:.4f} live_pairs={pairs} "
          f"bytes_moved={moved} bound_ms={bound_ms:.5f} "
          f"(operations {ops_ms:.5f}, bytes {bytes_ms:.5f}) "
          f"bound_share={bound_ms / ms:.4f} library_ms=none "
          f"(no single PyTorch call computes a masked, range-gated exact "
          f"top-k of pair distances) cdist_topk_ms={cdist_ms:.4f} "
          f"(torch.cdist + topk: NOT the same function, never called by the "
          f"port) [{card}]", flush=True)
    check(mismatch == 0, f"{name}: {mismatch} index mismatches")
    check(err <= SQD_ATOL, f"{name}: sqd error {err} > {SQD_ATOL}")
    check(dead_ok, f"{name}: rows past qcnt are not empty")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def tie_and_small_count_checks(card):
    """The tie rule across split and tile boundaries, and target counts of
    0, 1 and fewer than S, each against the plain version and against the
    plain two-stage reference (``ops/knn.split_merge``)."""
    rng = np.random.default_rng(5)
    for k in (5, 1):
        cfg = cuda_knn.kernel_config(k)
        Q, T, S = 300, 9 * cfg.tile + 77, 3
        # One point, far from all others, copied into original indices
        # whose compacted slots fall into all three splits and into
        # different tiles of one split; every third target is invalid, so
        # slots and indices differ.
        t = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
        mask = np.arange(T) % 3 != 1
        point = np.array([100.0, 100.0, 100.0], np.float32)
        slots_to_index = np.nonzero(mask)[0]
        tcnt = len(slots_to_index)
        length = -(-tcnt // S)
        dup_slots = [3, cfg.tile + 5, length - 1, length, length + cfg.tile,
                     2 * length + 1, tcnt - 1]
        dup_index = slots_to_index[dup_slots]
        t[dup_index] = point
        q = point + rng.normal(0, 0.1, (Q, 3)).astype(np.float32)
        q, t, mask = (torch.from_numpy(x).cuda() for x in (q, t, mask))
        prep = cuda_knn.prepare_targets(t, mask)
        idx, sqd = cuda_knn.knn_prepared(q, prep, k, 4.0, splits=S)
        pidx, psqd = plain_knn.knn(q, t, mask, k, 4.0)
        sidx, ssqd = plain_knn.split_merge(q, t, mask, k, 4.0, S)
        torch.cuda.synchronize()
        want = torch.from_numpy(dup_index[:k]).cuda().expand(Q, k)
        ok = bool(torch.equal(idx, want) and torch.equal(pidx, want)
                  and torch.equal(sidx, want)
                  and (sqd - psqd).abs().max() <= SQD_ATOL
                  and torch.equal(psqd, ssqd))
        print(f"ties k={k}: one point at compacted slots {dup_slots} of "
              f"{tcnt} (S={S} splits of {length}, tiles of {cfg.tile}): "
              f"kernel, plain and split_merge return the lower slots first "
              f"= {ok} [{card}]", flush=True)
        check(ok, f"k={k}: duplicates across splits and tiles come back in "
              f"another order than the plain version's")

        for count in (0, 1, 3):
            small = torch.zeros(T, dtype=torch.bool, device="cuda")
            small[torch.from_numpy(dup_index[:count]).cuda()] = True
            prep = cuda_knn.prepare_targets(t, small)
            pidx, psqd = plain_knn.knn(q, t, small, k, 4.0)
            same = True
            for splits in (None, 8):
                idx, sqd = cuda_knn.knn_prepared(q, prep, k, 4.0,
                                                 splits=splits)
                torch.cuda.synchronize()
                same &= bool(torch.equal(idx, pidx)
                             and (sqd - psqd).abs().max() <= SQD_ATOL)
            print(f"small count k={k}: {count} valid targets, planned S and "
                  f"S=8: kernel equals plain = {same} [{card}]", flush=True)
            check(same, f"k={k}: {count} valid targets differ from plain")


def small_linalg_times(card):
    """The ICP's rigid fit by Horn's method: the 4x4 ``symeig`` kernel
    alone (device time, a graph of calls), and the whole weighted fit at
    the ICP's query pad (host clock included: its ~20 small kernels)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(8192, 3, device="cuda", generator=g)
    w = torch.ones(8192, device="cuda")
    n4 = torch.randn(4, 4, device="cuda", generator=g)
    n4 = n4 + n4.T
    eig4_ms = graph_ms(lambda: symeig.launch(n4), GRAPH_CALLS)
    fit_ms = time_ms(lambda: se3.best_fit_transform(src, src + 0.1, w), 50)
    print(f"linalg: symeig_4x4_ms={eig4_ms:.4f} (device, graph of "
          f"{GRAPH_CALLS} calls) best_fit_transform_8192_ms={fit_ms:.4f} "
          f"(Horn, host clock; 15 fits per ICP) [{card}]", flush=True)


def symeig_flops(n, sweeps):
    """The fewest operations a Jacobi eigensolver needs on one matrix that
    took ``sweeps`` sweeps, the bound's count: each sweep's off-diagonal
    sum (2 a pair) and its n(n-1)/2 rotations (~16 for the angle, 8 for
    each of the 2n-2 entries of A and V a rotation updates), the last
    convergence test, the sort."""
    pairs = n * (n - 1) // 2
    rotation = 16 + 8 * (2 * n - 2)
    return sweeps * pairs * (2 + rotation) + 2 * pairs + pairs * 2 * (n + 1)


def symeig_schedule_ops(n, sweeps):
    """fp64 operations the kernel's parallel-ordered schedule issues on one
    matrix that took ``sweeps`` sweeps (a diagnostic, not the bound).  With
    m = n rounded up to even, a sweep is the off-diagonal sum (2 a square)
    and m - 1 rounds; a round is m / 2 angles (~20 each, the dummy
    index's too) and the updates of A's columns and rows and V's columns
    (3 a multiply and fused add, n^2 entries each).  Then the last
    convergence test and the ranks (n^2 compares)."""
    m = n + n % 2
    sweep = 2 * n * n + (m - 1) * (20 * (m // 2) + 9 * n * n)
    return sweeps * sweep + 2 * n * n + n * n


def symeig_errors(A_np, thresholds):
    """The kernel against the plain version (``torch.linalg.eigh`` on CPU
    copies) on a batch (B,n,n): eigenvalue error (abs, and x max|lambda|),
    reconstruction ||V L V^T - A|| / ||A||, orthogonality ||V^T V - I||
    (the kernel's, Frobenius, in float64), degeneracy projectors at the
    given per-matrix thresholds (``solver.degeneracy_projector`` under
    vmap on both sides) and whether their flags agree."""
    A = torch.from_numpy(A_np).cuda()
    w, V = symeig.symeig(A)
    thr = torch.from_numpy(thresholds)
    proj = torch.func.vmap(solver.degeneracy_projector)
    P, flag = proj(A, thr.cuda())
    torch.cuda.synchronize()
    wp, _ = symeig.symeig_plain(torch.from_numpy(A_np))
    Pp, flagp = proj(torch.from_numpy(A_np), thr)
    w64, V64 = w.cpu().double().numpy(), V.cpu().double().numpy()
    A64, wp64 = A_np.astype(np.float64), wp.double().numpy()
    top = np.abs(wp64).max(1)
    ev_abs = np.abs(w64 - wp64)
    recon = (V64 * w64[:, None, :]) @ V64.transpose(0, 2, 1) - A64
    eye = np.eye(A_np.shape[-1])
    return dict(
        ev_abs=float(ev_abs.max()),
        ev_rel=float((ev_abs.max(1) / top).max()),
        recon=float((np.linalg.norm(recon, axis=(1, 2))
                     / np.linalg.norm(A64, axis=(1, 2))).max()),
        orth=float(np.linalg.norm(V64.transpose(0, 2, 1) @ V64 - eye,
                                  axis=(1, 2)).max()),
        proj=float(np.abs(P.cpu().double().numpy()
                          - Pp.double().numpy()).max()),
        flags_equal=bool(torch.equal(flag.cpu(), flagp)),
        degenerate=int(flagp.sum()))


def gap_thresholds(A_np):
    """Per matrix, a degeneracy threshold in the middle of its widest
    eigenvalue gap where that gap is at least 5 % of max|lambda|, so that
    the projector is well defined (across a gap g an fp32 eigensolver's
    projector is good to ~6e-8 max|lambda| / g: a matrix of condition near
    1 has no such gap); every other threshold lies 1e-3 x max|lambda|
    under the smallest eigenvalue (no degenerate direction), far outside
    fp32 eigenvalue error (the smallest of a matrix of condition 1e8 is
    below it), and so does every odd matrix's."""
    w = np.linalg.eigvalsh(A_np.astype(np.float64))
    gaps = np.diff(w, axis=1)
    k = np.argmax(gaps, axis=1)
    rows = np.arange(len(w))
    top = np.abs(w).max(1)
    thr = w[:, 0] - 1e-3 * top
    split = (gaps[rows, k] >= 0.05 * top) & (rows % 2 == 0)
    thr[split] = ((w[rows, k] + w[rows, k + 1]) / 2)[split]
    return thr.astype(np.float32)


def symeig_empty_launch():
    """The library's empty kernel (the symeig block shape) on the current
    stream: the launch floor of a call in a graph."""
    err = cuda_knn._lib.symeig_empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: {err}")


def symeig_bound(n, B, sweeps):
    """(bound_ms, bound_by, bytes, ops, schedule_ops): the larger of the
    bytes in and out over the card's memory rate and the fewest operations
    a Jacobi solver needs for the sweeps these inputs took (``sweeps``,
    one count a matrix) over the card's fp32 rate (the function takes and
    returns fp32); beside them the operations the kernel's schedule
    issues."""
    moved = 4 * B * (2 * n * n + n)
    ops = sum(symeig_flops(n, int(s)) for s in sweeps)
    schedule_ops = sum(symeig_schedule_ops(n, int(s)) for s in sweeps)
    bytes_ms = 1e3 * moved / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_FP32_FLOPS
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    return bound_ms, bound_by, moved, ops, schedule_ops


def check_symeig_errors(err, what):
    for key in ("ev_rel", "recon", "orth", "proj"):
        check(err[key] <= SYMEIG_TOL,
              f"symeig {what}: {key} {err[key]} > {SYMEIG_TOL}")
    check(err["flags_equal"], f"symeig {what}: degeneracy flags differ")


def symeig_checks(scans, valids, gt, card):
    """The symeig kernel against its plain version: B = 1, 3 and 16 at
    n = 3, 4, 6 and the conditioned batch (B=4096, n=6), every error
    within SYMEIG_TOL and equal degeneracy flags; Horn's indefinite 4x4
    of a real ICP fit, repeated eigenvalues and a diagonal matrix
    (``symeig_special_checks``).  Each shape timed as a graph of
    GRAPH_CALLS calls beside the empty kernel's floor and the bound, at
    B=1 also beside the plain version and ``torch.linalg.eigh`` on the
    card.  Returns the JSON row's numbers (n=6, B=1: the joint LM's
    shape)."""
    floor_ms = graph_ms(symeig_empty_launch, GRAPH_CALLS)
    print(f"kernel symeig floor: an empty kernel of the same block shape "
          f"floor_ms={floor_ms:.5f} (device, graph of {GRAPH_CALLS} calls) "
          f"[{card}]", flush=True)
    rng = np.random.default_rng(21)          # B=1 and the conditioned batch
    rng_b = np.random.default_rng(22)        # B = 3 and 16
    row, worst_abs, times = None, 0.0, {}
    for n in SYMEIG_SIZES:
        for B in SYMEIG_BATCHES:
            A_np = (spd_batch(rng, 2, n, 1e3)[:1] if B == 1
                    else spd_batch(rng_b, B, n, 1e3))
            err = symeig_errors(A_np, gap_thresholds(A_np))
            A = torch.from_numpy(A_np).cuda()
            _, _, sweeps = symeig.launch(A, with_sweeps=True)
            sweeps = sweeps.cpu().numpy()
            ms = graph_ms(lambda: symeig.launch(A), GRAPH_CALLS)
            times[n, B] = ms
            bound_ms, bound_by, moved, ops, sched = symeig_bound(n, B, sweeps)
            line = (f"kernel symeig n={n} B={B}: sweeps={sweeps.min()}-"
                    f"{sweeps.max()} eig_err={err['ev_rel']:.2e} (x "
                    f"max|lambda|) eig_abs_err={err['ev_abs']:.3e} "
                    f"recon={err['recon']:.2e} orth={err['orth']:.2e} "
                    f"projector={err['proj']:.2e} flags_equal="
                    f"{err['flags_equal']} (tol {SYMEIG_TOL}) ms={ms:.5f} "
                    f"(device, graph of {GRAPH_CALLS} calls) "
                    f"x_floor={ms / floor_ms:.2f} bytes={moved} "
                    f"ops={ops} bound_ms={bound_ms:.3e} ({bound_by}) "
                    f"schedule_fp64_ops={sched}")
            if B == 1:
                worst_abs = max(worst_abs, err["ev_abs"])
                A_cpu = torch.from_numpy(A_np)
                symeig.symeig_plain(A_cpu)
                t0 = time.perf_counter()
                for _ in range(50):
                    symeig.symeig_plain(A_cpu)
                plain_ms = 1e3 * (time.perf_counter() - t0) / 50
                library_ms = time_ms(lambda: torch.linalg.eigh(A), 50)
                line += (f" plain_ms={plain_ms:.5f} (torch.linalg.eigh on "
                         f"the CPU) library_ms={library_ms:.5f} "
                         f"(torch.linalg.eigh on the card, host status read "
                         f"included; never called by the port)")
                if n == 6:
                    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=library_ms,
                               floor_ms=floor_ms)
            else:
                line += f" ratio_to_B1={ms / times[n, 1]:.3f}"
            print(line + f" [{card}]", flush=True)
            check_symeig_errors(err, f"n={n} B={B}")

    A_np = spd_batch(rng, SYMEIG_BATCH, 6, SYMEIG_COND)
    err = symeig_errors(A_np, gap_thresholds(A_np))
    A = torch.from_numpy(A_np).cuda()
    batch_ms = graph_ms(lambda: symeig.launch(A), GRAPH_CALLS)
    times[6, SYMEIG_BATCH] = batch_ms
    _, _, sweeps = symeig.launch(A, with_sweeps=True)
    sweeps = sweeps.cpu().numpy()
    bound_ms, bound_by, moved, ops, sched = symeig_bound(6, SYMEIG_BATCH,
                                                         sweeps)
    print(f"kernel symeig n=6 B={SYMEIG_BATCH} (condition numbers up to "
          f"{SYMEIG_COND:.0e}): eig_err={err['ev_rel']:.2e} (x max|lambda|) "
          f"recon={err['recon']:.2e} orth={err['orth']:.2e} "
          f"projector={err['proj']:.2e} flags_equal={err['flags_equal']} "
          f"({err['degenerate']} degenerate) sweeps={sweeps.min()}-"
          f"{sweeps.max()} (mean {sweeps.mean():.3f}) ms={batch_ms:.5f} "
          f"(device, graph of {GRAPH_CALLS} calls) ops={ops} "
          f"bound_ms={bound_ms:.3e} ({bound_by}) schedule_fp64_ops={sched} "
          f"[{card}]", flush=True)
    check_symeig_errors(err, "batch")
    check(int(sweeps.max()) < SYMEIG_MAX_SWEEPS,
          "symeig batch: a matrix hit the sweep cap")
    print("kernel symeig ms by (n, B): " + " ".join(
        f"{n},{B}={ms:.5f}" for (n, B), ms in times.items())
        + f" floor_ms={floor_ms:.5f} [{card}]", flush=True)
    symeig_special_checks(card)
    horn_checks(scans, valids, gt, card)
    row["max_abs_err"] = worst_abs
    return row


def symeig_special_checks(card):
    """Repeated eigenvalues (n = 6, 4, 3: the kernel's projector onto each
    eigenvalue's space against the plain version's) and a diagonal matrix
    (no sweep; the sorted diagonal exactly, V a permutation)."""
    rng = np.random.default_rng(23)
    for evals in ((1, 1, 1, 5, 5, 9), (2, 2, 7, 7), (4, 4, 4)):
        evals = np.asarray(evals, np.float64)
        n = len(evals)
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        A_np = (Q * evals) @ Q.T
        A_np = ((A_np + A_np.T) / 2).astype(np.float32)[None]
        w, V = symeig.symeig(torch.from_numpy(A_np).cuda())
        wp, Vp = symeig.symeig_plain(torch.from_numpy(A_np))
        w, V = w.cpu().double().numpy()[0], V.cpu().double().numpy()[0]
        wp, Vp = wp.double().numpy()[0], Vp.double().numpy()[0]
        ev_abs = float(np.abs(w - wp).max())
        ev_rel = ev_abs / float(np.abs(wp).max())
        proj = 0.0
        for value in np.unique(evals):       # ascending, as the outputs
            cols = np.flatnonzero(evals == value)
            P = V[:, cols] @ V[:, cols].T
            Pp = Vp[:, cols] @ Vp[:, cols].T
            proj = max(proj, float(np.abs(P - Pp).max()))
        print(f"kernel symeig repeated eigenvalues {evals.tolist()}: "
              f"eig_err={ev_rel:.2e} (x max|lambda|) eigenspace_projector="
              f"{proj:.2e} (tol {SYMEIG_TOL}) [{card}]", flush=True)
        check(ev_rel <= SYMEIG_TOL and proj <= SYMEIG_TOL,
              f"symeig repeated eigenvalues {evals.tolist()}: eigenvalues "
              f"{ev_rel} or projectors {proj} > {SYMEIG_TOL}")
    diag = np.array([3, -1, 2, 2, 0, 5], np.float32)
    D = torch.from_numpy(np.diag(diag)[None]).cuda()
    w, V, sweeps = symeig.launch(D, with_sweeps=True)
    w, V, sweeps = w.cpu().numpy()[0], V.cpu().numpy()[0], int(sweeps[0])
    perm = bool(np.isin(V, (0.0, 1.0)).all() and (V.sum(0) == 1).all()
                and (V.sum(1) == 1).all())
    exact = bool(np.array_equal(w, np.sort(diag))
                 and np.array_equal(V @ np.diag(w) @ V.T, np.diag(diag)))
    print(f"kernel symeig diagonal {diag.tolist()}: sweeps={sweeps} w={w} "
          f"V a permutation {perm}, exact {exact} [{card}]", flush=True)
    check(sweeps == 0 and perm and exact,
          "symeig diagonal: not the sorted diagonal without a sweep")


def horn_checks(scans, valids, gt, card):
    """Horn's 4x4 matrices of a real ICP fit (traceless, so indefinite;
    the fit takes the eigenvector of the largest eigenvalue):
    ``icp.align`` on the card aligns scan HORN_SCANS[1] (icp_query_pad of
    its valid points) onto scan HORN_SCANS[0] (history_pad of them) of the
    drive from their true relative pose moved by 0.3 m and 2 degrees,
    every ``se3.best_fit_transform`` call and its 4x4 recorded.  The
    points are those 0.5 m above each scan's lowest: a scan's ground gives
    a point-to-point fit no hold in the plane, and with it the fit slides
    metres away.  Each 4x4: the kernel against the plain version
    (eigenvalues, the top eigenvector's projector); each fit: its rotation
    on the card against the same call on CPU copies; the fit itself within
    FACTOR_TOL_M of the truth."""
    cfg = default_config()
    i0, i1 = HORN_SCANS

    def cloud(i, n):
        pts = scans[i][valids[i]]
        pts = pts[pts[:, 2] > pts[:, 2].min() + 0.5]
        pts = pts[::max(1, len(pts) // n)][:n]
        return torch.from_numpy(np.ascontiguousarray(pts)).cuda()

    dst, src = cloud(i0, cfg.cap.history_pad), cloud(i1, cfg.cap.icp_query_pad)
    a = np.radians(2.0)
    nudge = np.array([[np.cos(a), -np.sin(a), 0, 0.3],
                      [np.sin(a), np.cos(a), 0, 0.0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
    T0 = nudge @ np.linalg.inv(gt[i0]) @ gt[i1]        # dst ~ T0 @ src
    T0 = torch.from_numpy(T0.astype(np.float32)).cuda()
    fits, mats = [], []
    fit, eig = se3.best_fit_transform, se3.symeig

    def record_fit(p, q, w=None):
        T = fit(p, q, w)
        fits.append((p.clone(), q.clone(), None if w is None else w.clone(),
                     T.clone()))
        return T

    def record_eig(N):
        mats.append(N.clone())
        return eig(N)

    se3.best_fit_transform, se3.symeig = record_fit, record_eig
    try:
        T, fitness, inliers = icp.align(
            cfg, src, torch.ones(len(src), dtype=torch.bool, device="cuda"),
            dst, torch.ones(len(dst), dtype=torch.bool, device="cuda"), T0)
    finally:
        se3.best_fit_transform, se3.symeig = fit, eig
    N = torch.stack(mats)
    w, V = symeig.symeig(N)
    wp, Vp = symeig.symeig_plain(N.cpu())
    w, V = w.cpu().double().numpy(), V.cpu().double().numpy()
    wp, Vp = wp.double().numpy(), Vp.double().numpy()
    ev_abs = np.abs(w - wp).max(1)
    ev_rel = float((ev_abs / np.abs(wp).max(1)).max())
    top, top_p = V[:, :, 3], Vp[:, :, 3]
    proj = float(np.abs(top[:, :, None] * top[:, None, :]
                        - top_p[:, :, None] * top_p[:, None, :]).max())
    indefinite = bool(((wp[:, 0] < 0) & (wp[:, 3] > 0)).all())
    rot = 0.0
    for p, q, wt, T_card in fits:
        T_cpu = fit(p.cpu(), q.cpu(), None if wt is None else wt.cpu())
        rot = max(rot, float((T_card.cpu()[:3, :3] - T_cpu[:3, :3])
                             .abs().max()))
    truth = np.linalg.inv(gt[i0]) @ gt[i1]
    moved = float(np.linalg.norm(T.cpu().numpy()[:3, 3] - truth[:3, 3]))
    print(f"kernel symeig Horn 4x4 of an ICP fit (scan {i1} onto scan {i0}, "
          f"{len(src)} x {len(dst)} points, {len(mats)} fits): indefinite "
          f"{indefinite} (eigenvalues {wp[-1].round(1)}) eig_err={ev_rel:.2e} "
          f"(x max|lambda|) eig_abs_err={float(ev_abs.max()):.3e} "
          f"top_projector={proj:.2e} rotation_vs_cpu="
          f"{rot:.2e} (tol {SYMEIG_TOL}); fitness {float(fitness):.4f}, "
          f"inliers {float(inliers):.3f}, translation off the truth "
          f"{moved:.4f} m [{card}]", flush=True)
    check(len(mats) == len(fits) == cfg.loop.icp_max_iterations,
          "Horn: the ICP made another number of fits")
    check(indefinite, "Horn: a 4x4 that is not indefinite")
    check(moved < FACTOR_TOL_M, f"Horn: the ICP fit ended {moved} m off")
    check(ev_rel <= SYMEIG_TOL and proj <= SYMEIG_TOL and rot <= SYMEIG_TOL,
          f"Horn: eigenvalues {ev_rel}, projector {proj} or rotation {rot} "
          f"> {SYMEIG_TOL}")


def make_drive(cfg, drive, card):
    """One of ``DRIVES``, rays cast in worker processes."""
    n_scans, (trajectory, shape) = DRIVES[drive]
    kw = dict(trajectory=trajectory.__name__.removesuffix("_trajectory"),
              noise=0.01, seed=11, shuffle=False, skew=True, **shape)
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    scans, valids, gt = synthetic.make_sequence(cfg.lidar, n_scans,
                                                workers=workers, **kw)
    took = time.perf_counter() - t0
    # The first scan once more, serially: the fan-out changed no bit.
    poses = trajectory(n_scans + 1, **shape)
    pts0, valid0 = synthetic.raycast_skewed(
        synthetic.default_world(seed=11), poses[0], poses[1], cfg.lidar,
        noise=0.01, rng=np.random.default_rng(12))
    check(np.array_equal(pts0, scans[0]) and np.array_equal(valid0, valids[0]),
          "scan 0 from the worker processes differs from the serial one")
    print(f"data: {drive}, {n_scans} scans of {scans.shape[1]} points, host "
          f"generation {took:.2f} s in {workers} processes, scan 0 equals "
          f"the serial ray cast [{card}]", flush=True)
    return scans, valids, gt


def sync_warnings(rec):
    return [w for w in rec if "synchroniz" in str(w.message)]


def where(w) -> str:
    return f"{w.filename}:{w.lineno}"


def print_syncs(label, syncs):
    for at, n in Counter(where(w) for w in syncs).most_common():
        print(f"  {label} host sync x{n} at {at}", flush=True)


def expected_k5(cfg, map_ticks: int) -> int:
    m = cfg.mapping
    researches = 1 + sum(1 for it in range(1, m.max_iterations)
                         if it % m.research_every == 0)
    return 2 * researches * map_ticks


def loop_off(cfg):
    return cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=False))


def run_slice(cfg, label, pts, msk, gt, card):
    """``cfg`` (loop closure off) over the drive's first scans.  Returns
    (kNN launches, host syncs in the timed window)."""
    check(not cfg.loop.enabled, f"{label}: loop closure is on")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlamEngine(cfg)
    check(engine.device.type == "cuda", "the default device is not the card")
    reset_counts()
    for i in range(SLICE_WARMUP):
        engine.process_scan(pts[i], msk[i], t=i * 0.1)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i in range(SLICE_WARMUP, SLICE_SCANS):
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()              # the window's one deliberate sync
    wall = time.perf_counter() - t0
    launches = launch_counts()
    syncs = sync_warnings(rec)
    peak = torch.cuda.max_memory_allocated()

    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    n_kf = int(engine.m.kf.count)
    expected = expected_k5(cfg, engine.map_ticks)
    timed = SLICE_SCANS - SLICE_WARMUP
    fps = timed / wall
    print(f"{label}: scans={SLICE_SCANS} "
          f"warmup={SLICE_WARMUP} scans_per_s={fps:.3f} "
          f"ms_per_scan={1e3 / fps:.3f} peak_mem_bytes={peak} "
          f"keyframes={n_kf} mapping_ticks={engine.map_ticks} "
          f"knn_launches_k5={launches[5]} (expected {expected}) "
          f"knn_launches_k1={launches[1]} "
          f"host_syncs_timed_window={len(syncs)} "
          f"({len(syncs) / timed:.2f} a scan) ate_m={ate:.4f} "
          f"[{card}]", flush=True)
    print_syncs(label, syncs)
    check(est.shape == (SLICE_SCANS, 4, 4), f"trajectory shape {est.shape}")
    check(bool(np.isfinite(est).all()), "trajectory is not finite")
    check(launches[5] > 0 and launches[5] == expected,
          f"{label}: k=5 launches {launches[5]}, expected {expected}")
    check(launches[1] == 0, f"{label}: k=1 launches {launches[1]}, loops off")
    check(engine.loop_ticks == 0, f"{label}: a loop tick ran with loops off")
    check(ate < ATE_BAR, f"{label}: ATE {ate} >= {ATE_BAR} m")
    check(n_kf > 0, f"{label}: no keyframe inserted")
    stray = stray_syncs(syncs)
    check(not stray, f"{label}: a host sync: "
          + ", ".join(sorted({where(w) for w in stray})))
    check(launches["symeig"] > 0, f"{label}: symeig never launched")
    check_graphs(label, engine, card)
    return launches, len(syncs)


def stray_syncs(syncs, allowed=()):
    """Those not raised by the watch's own switch inside torch/cuda (and
    not among the ``allowed`` warnings' ids)."""
    return [w for w in syncs if id(w) not in allowed
            and not where(w).rsplit(":", 1)[0].endswith(SYNC_FILES)]


def check_graphs(label, engine, card):
    """The engine ran its steps as graph replays (the loop tick's too
    where loop closure is on and it ticked more than once), and no replay
    copied a leaf of a MiB or more into the graphs (the banks stay in
    place).  Prints what the graphs hold."""
    ticking = engine.config.loop.enabled and engine.loop_ticks > 1
    check(engine.graphs is not None
          and all(g.captured and g.replays > 0 for g in engine.graphs[:2])
          and (engine.graphs[2].replays > 0) == ticking,
          f"{label}: the steps did not run as CUDA graph replays")
    largest = max(g.copies.largest for g in engine.graphs)
    print(f"{label} graphs: {graphs.summary(engine.graphs)} "
          f"pool_bytes_total={sum(g.pool_bytes for g in engine.graphs)} "
          f"[{card}]", flush=True)
    check(largest < COPY_LIMIT, f"{label}: a {largest}-byte leaf was copied "
          f"into the graphs")


class CaptureWatch:
    """Tags the warnings recorded during graph captures: a capture
    synchronizes once before it starts (``torch.cuda.graph``), on purpose;
    a step that synchronized inside would fail its capture."""

    def __init__(self):
        self.rec: list = []
        self.ids: set = set()
        self.captures = 0

    def __enter__(self):
        self.inner = graphs.CudaCapture.capture
        watch = self

        def capture(backend, fn):
            n0 = len(watch.rec)
            try:
                return watch.inner(backend, fn)
            finally:
                watch.ids.update(id(w) for w in watch.rec[n0:])
                watch.captures += 1

        graphs.CudaCapture.capture = capture
        return self

    def __exit__(self, *exc):
        graphs.CudaCapture.capture = self.inner


def imu_feeder(engine, gt):
    """The bench's IMU stream for the drive (100 Hz, synthesized from the
    scan-end ground-truth poses, seed 11) and ``feed(i)``, which pushes the
    samples up to scan i's end in one batch.  Returns (feed, batch sizes)."""
    times, rpy, acc, gyro = synthetic.make_imu_samples(
        gt, t0=0.1, period=0.1, rate_hz=100, seed=11)
    ends = np.searchsorted(times, (np.arange(len(gt)) + 1) * 0.1 + 1e-9,
                           side="right")
    starts = np.concatenate([[0], ends[:-1]])
    sizes = []

    def feed(i):
        lo, hi = starts[i], ends[i]
        if hi > lo:       # one padded batch per scan
            engine.push_imu_batch(times[lo:hi], rpy[lo:hi], acc[lo:hi],
                                  gyro[lo:hi])
            sizes.append(hi - lo)

    return feed, sizes


def run_loop_path(cfg, label, pts, msk, gt, card, with_imu=False,
                  revisits=True):
    """``cfg`` (loop closure on) over the drive ``gt`` gives; with
    ``with_imu`` the IMU stream is fed scan by scan.  ``revisits``: the
    drive revisits a place, and at least one loop must close with every
    factor true; without, none may close and no factor be accepted.
    Returns (kNN launches, engine, a summary dict)."""
    n_scans = len(gt)
    check(cfg.loop.enabled and cfg.imu.enabled == with_imu,
          f"{label}: not the configuration it names")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the scans, an earlier path's engine
    engine = SlamEngine(cfg)
    engine.trace.on()           # its host spans are read after the drive
    feed_imu, batch_sizes = imu_feeder(engine, gt) if with_imu \
        else ((lambda i: None), [])
    reset_counts()

    # Watch every loop tick from outside the graphs: which recorded
    # warnings fall inside it, CUDA events around it, the host clock, its
    # k=1 kNN calls (host and device counters) and the closure counter
    # (device copies, read after the run), whether it was the loop
    # graph's warm-up, capture or a replay, and a copy of the small leaves
    # of the state going in (the closing-tick phase rebuilds it).
    rec: list = []
    ticks = []
    inner = engine.loop_tick

    def watched_tick():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        calls = engine.graphs[2].calls
        small = [(name, x.clone()) for name, x in
                 export.state_leaves(engine.m, "m.")
                 if x.numel() * x.element_size() < SMALL_LEAF]
        n0, k0 = len(rec), k1_mark()
        ev0.record()
        h0 = time.perf_counter()
        inner()
        host_ms = 1e3 * (time.perf_counter() - h0)
        ev1.record()
        ticks.append(dict(w0=n0, w1=len(rec), ev0=ev0, ev1=ev1,
                          host_ms=host_ms, k0=k0, k1=k1_mark(), small=small,
                          closed_after=engine.m.loops_closed.clone(),
                          kind="capture" if calls == 0 else "replay"))

    engine.loop_tick = watched_tick
    with CaptureWatch() as captures:
        for i in range(LOOP_WARMUP):
            feed_imu(i)
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            rec = captures.rec = caught
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            for i in range(LOOP_WARMUP, n_scans):
                feed_imu(i)
                engine.process_scan(pts[i], msk[i], t=i * 0.1)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()          # the window's one final sync
        wall = time.perf_counter() - t0
    del engine.loop_tick
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # Syncs: those inside a loop tick, and the rest; the graph captures'
    # own (one before each capture) apart.
    all_syncs = sync_warnings(rec)
    in_tick = set()
    for tk in ticks:
        in_tick.update(id(w) for w in rec[tk["w0"]:tk["w1"]])
    loop_syncs = [w for w in all_syncs if id(w) in in_tick]
    other_syncs = [w for w in all_syncs if id(w) not in in_tick]
    in_capture = [w for w in all_syncs if id(w) in captures.ids]

    closed_before = 0
    for tk in ticks:
        after = int(tk["closed_after"])
        tk["closed"] = after > closed_before
        closed_before = after
        tk["ms"] = tk["ev0"].elapsed_time(tk["ev1"])
        tk["syncs"] = len([w for w in sync_warnings(rec[tk["w0"]:tk["w1"]])
                           if id(w) not in captures.ids])
        tk["k1"] = k1_between(tk["k0"], tk["k1"])

    def mean(xs):
        return sum(xs) / len(xs) if xs else float("nan")

    replays = [tk for tk in ticks if tk["kind"] == "replay"]
    closed = [tk for tk in replays if tk["closed"]]
    verified = [tk for tk in replays if tk["k1"] > 0 and not tk["closed"]]
    idle = [tk for tk in replays if tk["k1"] == 0]

    est = engine.trajectory_array()
    raw = engine.trajectory_array(retro_correct=False)
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    ate_raw = evaluate.ate_rmse(raw, gt[:len(raw)])
    pr = evaluate.loop_precision_recall(engine, gt, cfg, tol_m=FACTOR_TOL_M)
    n_kf = int(engine.m.kf.count)
    loops_closed = int(engine.loops_closed)
    timed = n_scans - LOOP_WARMUP
    fps = timed / wall
    expected5 = expected_k5(cfg, engine.map_ticks)
    k1_cap = 2 * engine.loop_ticks * (cfg.loop.icp_max_iterations + 1)
    stages = engine.trace.summary(skip_first=LOOP_WARMUP)

    print(f"{label}: scans={n_scans} "
          f"warmup={LOOP_WARMUP} scans_per_s={fps:.3f} "
          f"ms_per_scan={1e3 / fps:.3f} peak_mem_bytes={peak} "
          f"(of which {held} held before the path began) "
          f"keyframes={n_kf} mapping_ticks={engine.map_ticks} "
          f"loop_ticks={engine.loop_ticks} "
          f"knn_launches_k5={launches[5]} (expected {expected5}) "
          f"knn_launches_k1={launches[1]} (at most {k1_cap}) "
          f"loops_closed={loops_closed} [{card}]", flush=True)
    print(f"{label} stages, host ms to launch (mean): " + " ".join(
        f"{name}={1e3 * st['mean']:.2f} (n={st['n']})"
        for name, st in sorted(stages.items())) + f" [{card}]", flush=True)
    if with_imu:
        print(f"{label}: imu_batches={len(batch_sizes)} samples_per_batch="
              f"{min(batch_sizes)}-{max(batch_sizes)} (pad "
              f"{engine.IMU_BATCH_PAD}) imu_samples_buffered="
              f"{int(engine.p.imu.count)} [{card}]", flush=True)
        check(int(engine.p.imu.count) == sum(batch_sizes) > n_scans,
              f"{label}: the buffer did not take every sample")
    print(f"{label} factors: accepted={pr['accepted']} "
          f"true={pr['true_factors']} precision={pr['precision']} "
          f"recall={pr['recall']} revisit_events={pr['revisit_events']} "
          f"(gate {FACTOR_TOL_M} m) ate_m={ate:.4f} "
          f"ate_as_published_m={ate_raw:.4f} [{card}]", flush=True)
    for tk in ticks:
        if tk["kind"] != "replay":
            print(f"{label} loop tick {tk['kind']} (a warm-up on copies "
                  f"of the small leaves, gates in 'select' mode, then the "
                  f"capture and a replay): ms_cuda_events={tk['ms']:.3f} "
                  f"ms_host={tk['host_ms']:.3f} closed={tk['closed']} "
                  f"k1_launches={tk['k1']} [{card}]", flush=True)
    for name, group in (("closed", closed), ("verified, not closed", verified),
                        ("no candidate", idle)):
        print(f"{label} loop tick replays {name}: n={len(group)} "
              f"mean_ms_cuda_events={mean([t['ms'] for t in group]):.3f} "
              f"mean_ms_host={mean([t['host_ms'] for t in group]):.3f} "
              f"max_ms_host={max([t['host_ms'] for t in group], default=0):.3f} "
              f"mean_host_syncs={mean([t['syncs'] for t in group]):.2f} "
              f"mean_k1_launches={mean([t['k1'] for t in group]):.2f} "
              f"[{card}]", flush=True)
    print(f"{label} host syncs in the {timed} timed scans: loop_ticks="
          f"{len([w for w in loop_syncs if id(w) not in captures.ids])} "
          f"elsewhere={len([w for w in other_syncs if id(w) not in captures.ids])}"
          f" graph_captures={len(in_capture)} ({captures.captures} "
          f"captures) [{card}]", flush=True)
    print_syncs("loop tick", [w for w in loop_syncs
                              if id(w) not in captures.ids])
    print_syncs("elsewhere", [w for w in other_syncs
                              if id(w) not in captures.ids])
    print_syncs("graph captures", in_capture)

    check(est.shape == (n_scans, 4, 4), f"trajectory shape {est.shape}")
    check(bool(np.isfinite(est).all()) and bool(np.isfinite(raw).all()),
          f"{label}: trajectory is not finite")
    check(sum(tk["closed"] for tk in ticks) == loops_closed,
          "closed ticks and loops_closed differ")
    check(launches[1] <= k1_cap,
          f"{label}: k=1 launches {launches[1]} over {k1_cap}")
    check(launches[5] == expected5,
          f"{label}: k=5 launches {launches[5]}, expected {expected5}")
    if revisits:
        check(loops_closed >= 1 and launches[1] > 0,
              f"{label}: no loop closed")
        check(pr["accepted"] >= 1 and pr["precision"] == 1.0,
              f"{label}: accepted factors not all true: {pr}")
    else:
        check(loops_closed == 0 and pr["accepted"] == 0,
              f"{label}: a loop closed on a drive without a revisit: {pr}")
    check(ate < ATE_BAR, f"{label}: ATE {ate} >= {ATE_BAR} m")
    # Every step is a graph replay, which cannot sync (the loop tick's
    # gates are conditional nodes); nothing around them does either (the
    # IMU pushes included): the whole window, loop ticks included, holds
    # no sync but the captures' own.
    stray = stray_syncs(all_syncs, captures.ids)
    check(not stray, f"{label}: a host sync in the timed window: "
          + ", ".join(sorted({where(w) for w in stray})))
    check(engine.graphs[2].captured and len(replays) == len(ticks) - 1,
          f"{label}: the loop ticks did not run as graph replays")
    # The ICP's rigid fit is Horn's method on the symeig kernel: no svd.
    fit = [w for w in loop_syncs if "utils/se3.py" in where(w)]
    check(not fit, f"{label}: the ICP fit synchronized: "
          + ", ".join(sorted({where(w) for w in fit})))
    check(launches["symeig"] > 0, f"{label}: symeig never launched")
    check_graphs(label, engine, card)
    summary = dict(scans_per_s=fps, ate=ate, ate_raw=ate_raw,
                   syncs_elsewhere=len(stray), peak=peak - held,
                   ticks=ticks, est=est)
    return launches, engine, summary


def run_closing_tick(cfg, engine, summary, card):
    """The loop path's last closing tick again, from the state going into
    it: its small leaves as the watch copied them, the keyframe and
    descriptor banks as the path left them with the rows appended after the
    tick back at their initial value.  The eager tick (host reads) and a
    captured ``loop_step`` graph (conditional nodes; its first call the
    warm-up, gates in "select" mode) must give the same state bit for bit,
    and the state the path's own graphed tick left: its loop bank, and the
    keyframe poses up to the tick's count (a closed tick is the last to
    change either)."""
    ticks = summary["ticks"]
    closing = [i for i, tk in enumerate(ticks) if tk["closed"]]
    check(bool(closing), "closing tick: the loop path closed no loop")
    tk = ticks[closing[-1]]
    small = dict(tk["small"])
    rows = {"m.kf.": int(small["m.kf.count"]),
            "m.bank.": int(small["m.bank.count"])}
    fresh = dict(export.state_leaves(
        pipeline.init_mapper_state(cfg, engine.device), "m."))

    def rebuild(path, now):
        if path in small:
            return small[path].clone()
        prefix = path[:path.index(".", 2) + 1]
        check(prefix in rows, f"closing tick: a large leaf {path}")
        out = fresh[path]
        out[:rows[prefix]] = now[:rows[prefix]]
        return out

    state = export._with_leaves(engine.m, rebuild, "m.")
    del fresh

    def own_small(st):
        """Small leaves copied, the banks shared (the tick only reads
        them)."""
        return export._with_leaves(
            st, lambda _, x: x.clone()
            if x.numel() * x.element_size() < SMALL_LEAF else x, "m.")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = pipeline.loop_step(cfg, own_small(state))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    g = graphs.StepGraph(lambda m: (pipeline.loop_step(cfg, m),),
                         graphs.CudaCapture(engine.device), "loop_step")
    (warm,) = g(own_small(state))
    warm = [x.clone() for x in graphs.flatten(warm)]
    (graphed,) = g(own_small(state))
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    g._copy_in(graphs.flatten((own_small(state),)))
    ev0.record()
    g._replay()
    ev1.record()
    torch.cuda.synchronize()
    want = graphs.flatten(eager)
    same = all(torch.equal(a, b) for a, b in
               zip(graphs.flatten(graphed), want))
    same_warm = all(torch.equal(a, b) for a, b in zip(warm, want))
    k = rows["m.kf."]
    faithful = all(torch.equal(a, b) for a, b in zip(eager.loops,
                                                     engine.m.loops)) \
        and torch.equal(eager.kf.poses6[:k], engine.m.kf.poses6[:k])
    closed = int(eager.loops_closed) > int(small["m.loops_closed"])
    print(f"closing tick (the loop path's tick {closing[-1]}, "
          f"{k} keyframes): eager (host reads) s={eager_s:.3f}; graphed "
          f"replay ms_cuda_events={ev0.elapsed_time(ev1):.3f} "
          f"{graphs.summary([g])}; graphed bit-equal to eager={same} "
          f"warm-up ('select') bit-equal={same_warm} closed={closed} "
          f"equal to the loop path's own graphed tick={faithful} [{card}]",
          flush=True)
    check(closed, "closing tick: the rebuilt state did not close")
    check(same and same_warm, "closing tick: the graphed tick differs from "
          "the eager tick")
    check(faithful, "closing tick: the rebuilt tick differs from the loop "
          "path's own")
    del state, eager, graphed, warm, g
    free_memory()


def run_closing_latency(cfg, pts, msk, card):
    """Per-scan latency over a window that closes a loop: a fresh graphed
    engine over the whole loop drive, a synchronize after every scan (the
    bench's latency measure), the bench's WARMUP scans (in which the three
    graphs are captured) excluded.  Prints p50 / p95 / p99 / max, the
    closing scan's latency and the latency of the scans by their loop
    tick's outcome.  Returns the kNN launches."""
    torch.cuda.synchronize()
    engine = SlamEngine(cfg)
    reset_counts()
    lat, marks = [], []
    for i in range(len(pts)):
        ticks, k0 = engine.loop_ticks, k1_mark()
        closed0 = engine.m.loops_closed.clone()
        t0 = time.perf_counter()
        engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        marks.append((engine.loop_ticks > ticks, k0, k1_mark(), closed0,
                      engine.m.loops_closed.clone()))
    launches = launch_counts()
    kind = []
    for ticked, a, b, c0, c1 in marks:
        if not ticked:
            kind.append("no loop tick")
        elif int(c1) > int(c0):
            kind.append("closed")
        else:
            kind.append("verified" if k1_between(a, b) > 0
                        else "no candidate")
    w = bench.WARMUP
    window = np.asarray(lat[w:])
    pct = {q: float(np.percentile(window, q)) for q in (50, 95, 99)}
    by = {}
    for name in ("no loop tick", "no candidate", "verified", "closed"):
        xs = [x for x, k in zip(lat[w:], kind[w:]) if k == name]
        by[name] = xs
    closing = [i for i in range(w, len(lat)) if kind[i] == "closed"]
    print(f"closing-window latency (fresh graphed engine, default_config, "
          f"{len(lat)} scans, a synchronize after every scan, the first {w} "
          f"excluded): p50={pct[50]:.2f} p95={pct[95]:.2f} p99={pct[99]:.2f} "
          f"max={window.max():.2f} ms; closing scans {closing} at "
          f"{[round(lat[i], 2) for i in closing]} ms; knn_launches="
          f"{launches} [{card}]", flush=True)
    for name, xs in by.items():
        print(f"closing-window latency, scans with {name}: n={len(xs)} "
              f"mean_ms={np.mean(xs) if xs else float('nan'):.2f} max_ms="
              f"{max(xs, default=float('nan')):.2f} [{card}]", flush=True)
    check(bool(closing), "closing-window latency: no tick closed a loop in "
          "the window")
    check(bool(np.isfinite(window).all()), "closing-window latency: not "
          "finite")
    del engine
    free_memory()
    return launches


def write_mulran_directory(root, scans, valids, gt):
    """Scans as ``sensor_data/Ouster/<timestamp_ns>.bin`` (float32 x, y, z,
    intensity of the real returns) and ``global_pose.csv``, 10 Hz."""
    folder = os.path.join(root, "sensor_data", "Ouster")
    os.makedirs(folder)
    t0_ns = 1_566_535_000_000_000_000
    rows = []
    for i in range(len(scans)):
        ts = t0_ns + i * 100_000_000
        pts = scans[i][valids[i]]
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)],
                       1).tofile(os.path.join(folder, f"{ts}.bin"))
        rows.append([ts] + list(gt[i][:3, :4].reshape(-1)))
    np.savetxt(os.path.join(root, "global_pose.csv"),
               np.asarray(rows, np.float64), delimiter=",")


def run_runner(scans, valids, gt, card):
    """``runner.run_mulran`` on the card over the drive's first scans,
    written out in the MulRan layout; the native loader must serve."""
    with tempfile.TemporaryDirectory() as root:
        write_mulran_directory(root, scans[:RUNNER_SCANS],
                               valids[:RUNNER_SCANS], gt[:RUNNER_SCANS])
        reset_counts()
        t0 = time.perf_counter()
        res = runner.run_mulran(root)
        took = time.perf_counter() - t0
    launches = launch_counts()
    check(res["loader"] == "native", "runner: the native loader did not "
          f"serve: {native_io.why_unavailable()}")
    print(f"runner (run_mulran, default config, MulRan layout written from "
          f"the drive): loader={res['loader']} scans={res['scans']} "
          f"scans_per_s={res['fps']:.3f} (after 6 warm-up scans, scans read "
          f"from disk and uploaded) keyframes={res['keyframes']} "
          f"loops_closed={res['loops_closed']} "
          f"ate_rmse_m={res.get('ate_rmse_m', float('nan')):.4f} "
          f"gt_length_m={res.get('gt_length_m', float('nan')):.2f} "
          f"knn_launches_k5={launches[5]} seconds={took:.2f} "
          f"device={res['engine'].device} [{card}]", flush=True)
    check(res["scans"] == RUNNER_SCANS and res["engine"].device.type == "cuda",
          "runner: not every scan ran on the card")
    check("ate_rmse_m" in res and res["ate_rmse_m"] < ATE_BAR,
          f"runner: ate_rmse_m {res.get('ate_rmse_m')} missing or >= "
          f"{ATE_BAR} m")
    check(bool(np.isfinite(res["est"]).all()), "runner: trajectory not finite")
    check(launches[5] > 0, "runner: the kNN kernel was never launched")
    return launches


def checkpoint_resume(engine, pts, msk, card):
    """``engine`` (the loop path's end state: full-size banks, a closed loop
    in its factor bank) saved, loaded into a fresh engine on the card,
    every field compared bit for bit; then one more scan: its perception
    step once, and the mapping + loop step of both engines on the same
    inputs."""
    cfg = engine.config
    with tempfile.TemporaryDirectory() as folder:
        path = os.path.join(folder, "engine.npz")
        t0 = time.perf_counter()
        export.save_checkpoint(path, engine)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        resumed = SlamEngine(cfg)
        t0 = time.perf_counter()
        export.load_checkpoint(path, resumed)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    raw = 0
    differing = []

    def leaves(eng):
        return [*export.state_leaves(eng.p, "p."),
                *export.state_leaves(eng.m, "m.")]

    for (name, a), (_, b) in zip(leaves(engine), leaves(resumed)):
        raw += a.numel() * a.element_size()
        if a.dtype != b.dtype or b.device.type != "cuda" \
                or not torch.equal(a, b) or a.data_ptr() == b.data_ptr():
            differing.append(name)
    host_equal = all(getattr(engine, f) == getattr(resumed, f) for f in
                     ("map_ticks", "loop_ticks", "last_map_time"))
    same_traj = np.array_equal(engine.trajectory_array(),
                               resumed.trajectory_array())

    # One more scan: the drive's last once more, as if the sensor stood.
    scan, mask = pts[-1], msk[-1]
    t = torch.full((), len(pts) * 0.1, device="cuda")
    p, odom_pose, out_pts, out_mask, _ = pipeline.perception_step(
        cfg, engine.p, engine.m.correction, scan, mask, t)
    poses = []
    for eng in (engine, resumed):
        m = pipeline.mapping_step(
            cfg, eng.m, p.odo.corner_last.xyz, p.odo.corner_last.mask,
            p.odo.surf_last.xyz, p.odo.surf_last.mask, out_pts, out_mask,
            odom_pose, scan, mask, t, p.imu)
        m = pipeline.loop_step(cfg, m)
        poses.append(m.pose.cpu().numpy())
    # Since the sums on the path are ordered (sorting index_puts), the two
    # steps run the same kernels on the same bits: equal, not near.
    same_step = bool(np.array_equal(poses[0], poses[1]))
    d_m = float(np.linalg.norm(poses[0][:3, 3] - poses[1][:3, 3]))
    # The angle between the rotations from the chord ||R0 - R1|| = 2 sqrt(2)
    # sin(angle / 2): 0 for equal matrices, where the trace of R0^T R1 is
    # not 3 once R0 drifts from orthonormal (by 1e-6 a slot: 0.1 deg).
    chord = np.linalg.norm(poses[0][:3, :3] - poses[1][:3, :3])
    d_deg = float(np.degrees(2 * np.arcsin(min(1.0, chord / 8 ** 0.5))))
    print(f"checkpoint (loop path's end state, {cfg.cap.max_keyframes}-"
          f"keyframe banks, np.savez_compressed): file_bytes={size} "
          f"state_bytes={raw} save_s={save_s:.2f} load_s={load_s:.2f} "
          f"fields_differing={len(differing)} host_counters_equal="
          f"{host_equal} trajectory_array_equal={same_traj} "
          f"next_mapping_and_loop_step: bit_equal={same_step} "
          f"d_pose_m={d_m:.2e} d_rot_deg={d_deg:.2e} [{card}]", flush=True)
    check(not differing, f"checkpoint: fields differ after load: {differing}")
    check(host_equal and same_traj, "checkpoint: the resumed engine's "
          "counters or trajectory differ")
    check(same_step, f"checkpoint: the resumed engine's next step differs: "
          f"{d_m} m, {d_deg} deg")


def real_cloud_checks(engine, clouds, card):
    """Kernel against plain version, and its time, on the loop path's own
    clouds (clustered along surfaces, not uniform).  k=5: the submap as the
    last keyframe's mapping tick saw it, queried with that keyframe's
    stored (downsampled) corner and surf + outlier features at its pose,
    compacted as ``mapping.scan_to_map`` compacts them.  k=1: ``clouds``,
    the keyframe cloud and history submap of the loop tick breakdown,
    compacted as ``icp.align`` compacts them."""
    cfg, kf = engine.config, engine.m.kf
    m = cfg.mapping
    last = (kf.count.long() - 1).reshape(1)
    sub_c, sub_cm, sub_s, sub_sm = mapping.build_submap(
        cfg, kf._replace(count=kf.count - 1))
    pose = se3.pose6_to_mat(kf.poses6[last][0])
    corner, corner_m = kf.corner[last][0], kf.corner_mask[last][0]
    surf = torch.cat([kf.surf[last][0], kf.outlier[last][0]])
    surf_m = torch.cat([kf.surf_mask[last][0], kf.outlier_mask[last][0]])
    src, src_mask, dst, dst_mask = clouds
    results = {}
    for name, k, q, qm, t, tm, max_sq in (
            ("real_s2m_surf_k5", m.knn, se3.transform_points(pose, surf),
             surf_m, sub_s, sub_sm, 4.0 * m.max_nn_sq_dist),
            ("real_s2m_corner_k5", m.knn, se3.transform_points(pose, corner),
             corner_m, sub_c, sub_cm, 4.0 * m.max_nn_sq_dist),
            ("real_icp_k1", 1, src, src_mask, dst, dst_mask,
             icp.NN_MAX_SQ_DIST)):
        q, qm = compact(q, qm, q.shape[0])
        qcnt = qm.sum(dtype=torch.int32).reshape(1)
        results[name] = kernel_vs_plain(name, k, q.contiguous(),
                                        t.contiguous(), tm, qcnt, max_sq,
                                        card)
    return results


def measure_parts(label, parts, card):
    """Per (name, fn), by ``profile_stages.measure`` (every part timed
    before any is profiled: a profiler session slows every later launch of
    the process, so this runs only after the drives): host time of a call
    that ends in a synchronize (mean of 3), the kernels one call launches
    and their summed device time (``torch.profiler``), and the host syncs it
    makes (sync debug mode)."""
    rows = profile_stages.measure([(name, fn, 3) for name, fn in parts],
                                  "cuda")
    out = {}
    for r in rows:
        print(f"{label}: {r['name']}: ms_synchronized={r['sync_ms']:.3f} "
              f"kernel_launches={r['launches']} "
              f"device_ms={r['kernel_ms']:.3f} host_syncs={r['syncs']} "
              f"[{card}]", flush=True)
        check(r["launches"] > 0, f"the profiler saw no kernel in: {r['name']}")
        out[r["name"]] = dict(launches=r["launches"], syncs=r["syncs"])
    return out


def imu_parts(engine, pts, msk, card):
    """What the IMU adds to a scan, on the IMU path's end state: the batch
    push (10 samples in the pad of 32, and a full pad), the de-skew of the
    segmented cloud's and the outlier grid's points, the rotation prior, and
    the roll / pitch blend of a mapping tick."""
    cfg, p = engine.config, engine.p
    rng = np.random.default_rng(3)
    t_last = float(p.imu.time.max())
    grid = cfg.lidar.n_scan * cfg.lidar.horizon_scan

    def batch(m):
        times = t_last + 0.01 * (1 + np.arange(m))
        return (times, rng.normal(0, 0.01, (m, 3)),
                rng.normal(0, 0.1, (m, 3)) + [0, 0, 9.81],
                rng.normal(0, 0.01, (m, 3)))

    ten, full = batch(10), batch(engine.IMU_BATCH_PAD)
    probe = SlamEngine(cfg)             # takes the pushes; same buffer size
    flat = pts[-1][:grid].contiguous()
    rel = torch.rand(grid, device="cuda")
    t = torch.full((), t_last - 0.1, device="cuda")
    v = torch.zeros(3, device="cuda")
    pose = engine.m.pose
    blend = cfg.imu.blend

    def blended():
        rpy = imu_mod.rpy_at(p.imu, t)
        p6 = se3.mat_to_pose6(pose)
        p6b = torch.cat([(1 - blend) * p6[:2] + blend * rpy[:2], p6[2:]])
        return torch.where(p.imu.count > 1, se3.pose6_to_mat(p6b), pose)

    parts = [
        ("push_imu_batch, 10 samples", lambda: probe.push_imu_batch(*ten)),
        ("push_imu_batch, 32 samples", lambda: probe.push_imu_batch(*full)),
        (f"imu.deskew_to_end, one grid of {grid} points (two a scan)",
         lambda: imu_mod.deskew_to_end(p.imu, flat, rel, t,
                                       cfg.lidar.scan_period, v)),
        ("imu.motion_prior", lambda: imu_mod.motion_prior(
            p.imu, t, t + cfg.lidar.scan_period)),
        ("roll / pitch blend (imu.rpy_at + pose6 round trip)", blended),
    ]
    got = measure_parts("imu part", parts, card)
    check(all(part["syncs"] == 0 for part in got.values()),
          "an IMU part synchronizes")
    check(got["push_imu_batch, 10 samples"]["launches"]
          == got["push_imu_batch, 32 samples"]["launches"],
          "push_imu_batch's launches depend on the number of samples")


def loop_tick_breakdown(engine, card):
    """Where a loop tick's time goes, on the loop path's end state and for
    its first accepted factor (newer keyframe i against older j, the Scan
    Context route: query cloud placed at j's pose), measured by
    ``measure_parts``.  Returns the ICP's clouds."""
    cfg, m = engine.config, engine.m
    kf = m.kf
    cur, cand = m.loops.i[0].long(), m.loops.j[0].long()
    desc = m.bank.desc[cur.reshape(1)][0]
    place = se3.pose6_to_mat(kf.poses6[cand.reshape(1)][0])
    yaw = torch.zeros((), device=cur.device)
    src, src_mask = loop.keyframe_cloud(cfg, kf, cur, place)
    dst, dst_mask = loop.history_submap(cfg, kf, cand)
    parts = [
        ("retrieval (scan_context.detect, 16384-descriptor bank)",
         lambda: scan_context.detect(cfg, m.bank, desc)),
        ("radius detection (loop.detect_radius)",
         lambda: loop.detect_radius(cfg, kf, cur)),
        ("history submap (51 keyframes -> 32768 points)",
         lambda: loop.history_submap(cfg, kf, cand)),
        ("keyframe cloud (8192 points)",
         lambda: loop.keyframe_cloud(cfg, kf, cur, place)),
        ("ICP (icp.align, 15 iterations + fitness pass)",
         lambda: icp.align(cfg, src, src_mask, dst, dst_mask)),
        ("one verification (loop.verify: clouds + ICP + gates)",
         lambda: loop.verify(cfg, kf, cur, cand, place, yaw_init=yaw)),
        ("factor insert (posegraph.add_loop, 256-slot bank)",
         lambda: posegraph.add_loop(m.loops, cur, cand, place, kf.poses6)),
        ("re-solve (posegraph.solve, 16384 nodes, 256 factor slots)",
         lambda: posegraph.solve(cfg, kf.poses6, kf.count, kf.odom_z,
                                 m.loops)),
    ]
    measure_parts("loop tick part", parts, card)
    return src, src_mask, dst, dst_mask


def prepare_targets_times(card):
    """``cuda_knn.prepare_targets`` (torch ops: compaction, 16-byte records,
    slot -> index map) at its callers' target pads: device ms in a replayed
    CUDA graph beside the bytes it must move (points and mask read; records,
    map and count written) over the card's memory rate."""
    for caller, T in (("scan-to-map surf submap", 65536),
                      ("scan-to-map corner submap", 16384),
                      ("ICP history submap", 32768)):
        _, t, mask, _ = uniform_cloud(T, 8, T)
        ms = graph_ms(lambda: cuda_knn.prepare_targets(t, mask), 10)
        moved = T * 12 + T + T * 16 + T * 8 + 4
        bound_ms = 1e3 * moved / PEAK_BYTES_PER_S
        print(f"prepare_targets: {caller}: T={T} ms={ms:.4f} (device, graph "
              f"of 10 calls) bytes_moved={moved} bound_ms={bound_ms:.5f} "
              f"(bytes) bound_share={bound_ms / ms:.4f} [{card}]", flush=True)


def set_condition_times(card):
    """``set_condition`` (``csrc/graph_nodes.cu``), the one-thread kernel
    that sets a CUDA-graph IF node from a device bool before the node:
    GRAPH_CALLS gates (``graphs.cond``, a one-element body) captured in one
    graph with the predicate false and true, beside a graph of the false
    side alone (the clone of its input that each gate makes before its
    node) and the empty kernel; device ms a gate, the least of 3 replays.
    A loop tick's graph launches it 3 times (two verifications and the
    re-solve), 22 when the re-solve's body runs (its 19 gated GN
    iterations), the batch's loop tick the same."""
    cap = graphs.CudaCapture("cuda")
    x = torch.zeros(1, device="cuda")

    def gates(value):
        pred = torch.full((), value, dtype=torch.bool, device="cuda")

        def fn():
            y = x
            for _ in range(GRAPH_CALLS):
                y = graphs.cond(pred, lambda y=y: y + 1.0, y)
            return y
        return fn

    def clones():
        y = x
        for _ in range(GRAPH_CALLS):
            y = y.clone()
        return y

    def empties():
        for _ in range(GRAPH_CALLS):
            symeig_empty_launch()
        return x

    out = {}
    for name, fn in (("false gate", gates(False)), ("true gate", gates(True)),
                     ("clone", clones), ("empty kernel", empties)):
        cap.warm_up(fn)
        replay, _, _ = cap.capture(fn)
        best = float("inf")
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / GRAPH_CALLS)
        out[name] = best
        if name == "true gate":
            check(float(y) == GRAPH_CALLS, "set_condition: a true gate's "
                  "body did not run")
        if name == "false gate":
            check(float(y) == 0.0, "set_condition: a false gate's body ran")
    print(f"kernel set_condition (graph_nodes.cu, one thread, IF node's "
          f"flag): ms a gate in a graph of {GRAPH_CALLS}: false "
          f"{out['false gate']:.5f}, true {out['true gate']:.5f} (body: an "
          f"add and a copy), the clone alone {out['clone']:.5f}, so "
          f"set_condition + its IF node "
          f"{out['false gate'] - out['clone']:.5f}; empty kernel "
          f"{out['empty kernel']:.5f} (the bound: a launch) [{card}]",
          flush=True)
    return out


def probe_times(card):
    """``probe`` (``csrc/graph_nodes.cu``), the one-thread kernel of the
    tracer's device records (``graphs.probe``): GRAPH_CALLS probes captured
    in one graph, replayed with the on-flag off (the cost the step graphs
    carry always: a perception replay holds 16) and on (a record each),
    beside the empty kernel; device ms a probe, the least of 3 replays.
    The records of the flag-on replays must be GRAPH_CALLS each, in launch
    order, with the value read at run time."""
    ring = graphs.ProbeRing("cuda")
    value = torch.zeros((), dtype=torch.int32, device="cuda")

    def probes():
        with graphs.probing(ring):
            for _ in range(GRAPH_CALLS):
                graphs.probe("loop.detect", value)
                value.add_(1)
        return value

    def empties():
        for _ in range(GRAPH_CALLS):
            symeig_empty_launch()
            value.add_(1)
        return value

    out = {}
    for name, fn, on in (("off", probes, False), ("on", probes, True),
                         ("empty kernel", empties, False)):
        stream = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            fn()
        ring.set(on)
        best = float("inf")
        for _ in range(4):
            value.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / GRAPH_CALLS)
        out[name] = best
        got = ring.drain()
        ring.set(False)
        if name == "off":
            check(got["records"] == [], "probe: a probe recorded with its "
                  "flag off")
        if name == "on":
            check(got["dropped"] == 0 and [v for _, _, v in got["records"]]
                  == [float(k) for k in range(GRAPH_CALLS)] * 4,
                  "probe: the records of the flag-on replays are not one a "
                  "probe, in order, with the value at run time")
    print(f"kernel probe (graph_nodes.cu, one thread, the tracer's device "
          f"record): ms a probe + an add in a graph of {GRAPH_CALLS}: flag "
          f"off {out['off']:.5f}, flag on {out['on']:.5f}; empty kernel + "
          f"an add {out['empty kernel']:.5f} (the bound: a launch) [{card}]",
          flush=True)
    return out


def probe_checks(cfg, engine, pts, msk, card):
    """The loop path's records, taken by the ``probe`` kernels captured in
    its three graphs (tracing was on for the whole drive), against the
    plain version: the CPU ``graphs.ProbeRing`` (host records of the
    values each probe reads) in a second engine over the same scans, its
    steps run through ``graphs.EagerStandIn`` (every gate in "select", a
    probe in a gate's body recording only where the gate took it).  Per
    scan the sites and values must be equal, no record dropped, one
    perception ``begin`` a call, and at least one closing loop tick among
    them."""
    graphed = engine.trace.drain()
    engine.trace.off()
    plain = SlamEngine(cfg)
    plain.trace.probes = graphs.ProbeRing("cpu")
    plain.use_graphs(graphs.EagerStandIn())
    plain.trace.on()
    t0 = time.perf_counter()
    for i in range(len(pts)):
        plain.process_scan(pts[i], msk[i], t=i * 0.1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    want = plain.trace.drain()

    def by_scan(records):
        scans = []
        for site, _, value in records:
            if site == "perception.begin":
                scans.append([])
            scans[-1].append((site, value))
        return scans

    got_scans, want_scans = by_scan(graphed["records"]), by_scan(
        want["records"])
    differ = [k for k, (a, b) in enumerate(zip(got_scans, want_scans))
              if a != b]
    ticks = [s["loop_tick"] for s in graphed["scans"] if s["loop_tick"]]
    closing = [t for t in ticks if t["closed"]]
    per_scan = Counter(len(r) for r in got_scans)
    sites = Counter(site for site, _, _ in graphed["records"])
    times = [t for _, t, _ in graphed["records"]]
    print(f"probe records (the loop path's three graphs, tracing on, "
          f"{len(got_scans)} scans) against the plain version (CPU "
          f"ProbeRing, EagerStandIn, {plain_s:.1f} s): records "
          f"{len(graphed['records'])} vs {len(want['records'])}, scans "
          f"differing {len(differ)} (first {differ[:5]}), dropped "
          f"{graphed['dropped']}, records a scan {dict(sorted(per_scan.items()))}, "
          f"loop ticks {len(ticks)} (closing {len(closing)}, verifications "
          f"{sites['loop.verify_begin']}, re-solves "
          f"{sites['loop.resolve_begin']}, GN iterations "
          f"{sites['loop.gn_iter']}), clock error "
          f"{graphed['error_ns']} ns [{card}]", flush=True)
    check(len(got_scans) == len(pts) == len(graphed["scans"]),
          "probe records: not one perception begin a scan")
    check(graphed["dropped"] == {"spans": 0, "records": 0},
          "probe records: dropped")
    check(not differ and len(got_scans) == len(want_scans),
          "probe records: the kernels' sites or values differ from the "
          "plain version's")
    check(bool(closing), "probe records: no closing loop tick")
    check(times == sorted(times), "probe records: not in device order")
    trace_equal = torch.equal(plain.m.kf.poses6, engine.m.kf.poses6)
    print(f"probe records: the plain engine's keyframe poses bit-equal to "
          f"the loop path's={trace_equal} [{card}]", flush=True)
    del plain
    free_memory()


# (name, k, queries, targets, max_sq_dist, items): the batch axis at the
# shapes a BatchEngine of three sequences gives the kernel (scan-to-map),
# and the ICP at three sequences and at the 8 pairs of verify_cross_loops.
BATCH_SHAPES = [
    ("s2m_surf_k5", 5, 12288, 65536, 4.0, 3),
    ("s2m_corner_k5", 5, 2048, 16384, 4.0, 3),
    ("icp_k1", 1, 8192, 32768, 64.0, 3),
    ("icp_k1", 1, 8192, 32768, 64.0, 8),
]


def batched_kernel_checks(card):
    """The kernel's batch axis: B items in one call against B single calls
    (equal in every slot) and against the plain version item by item; the
    B=8 batch holds one item with no valid target.  Timed as a replayed
    CUDA graph beside B single calls in one graph, with the bound the sum
    of the items' single bounds."""
    out = {}
    for seed, (name, k, Q, T, max_sq, B) in enumerate(BATCH_SHAPES):
        items = [uniform_cloud(100 * seed + b, Q, T) for b in range(B)]
        if B == 8:
            q1, t1, m1, c1 = items[1]
            items[1] = (q1, t1, torch.zeros_like(m1), c1)
        preps = [cuda_knn.prepare_targets(t, m) for _, t, m, _ in items]
        q_b = torch.stack([it[0] for it in items])
        qcnt_b = torch.cat([it[3] for it in items])
        tgt_b = torch.stack([p.tgt for p in preps])
        perm_b = torch.stack([p.perm for p in preps])
        cnt_b = torch.cat([p.cnt for p in preps])
        batched = lambda: cuda_knn.knn_op(  # noqa: E731
            q_b, tgt_b, perm_b, cnt_b, qcnt_b, k, max_sq, -1)
        singles = lambda: [cuda_knn.knn_prepared(  # noqa: E731
            it[0], pr, k, max_sq, it[3]) for it, pr in zip(items, preps)]
        idx, sqd = batched()
        ones = singles()
        torch.cuda.synchronize()
        equal = all(torch.equal(idx[b], i) and torch.equal(sqd[b], d)
                    for b, (i, d) in enumerate(ones))
        mismatch, err, dead_ok = 0, 0.0, True
        bound = 0.0
        for b, (q, t, m, qcnt) in enumerate(items):
            mm, e, dok, _, _ = compare_to_plain(idx[b], sqd[b], q, t, m, qcnt,
                                                k, max_sq)
            mismatch, err, dead_ok = mismatch + mm, max(err, e), dead_ok & dok
            bound += knn_bound(Q, T, k, int(qcnt.item()),
                               int(preps[b].cnt.item()))[0]
        empty_ok = B != 8 or bool((idx[1] == 0).all()
                                  and (sqd[1] == max_sq).all())
        ms = graph_ms(batched, GRAPH_CALLS)
        single_ms = graph_ms(singles, GRAPH_CALLS)
        plan = cuda_knn.plan(k, Q, T, "cuda", items=B)
        label = f"{name}_B{B}"
        print(f"batched kernel {label}: k={k} B={B} Q={Q} T={T} "
              f"splits={plan.splits} blocks={plan.blocks} (single call: "
              f"splits={cuda_knn.plan(k, Q, T, 'cuda').splits}) "
              f"equal_to_{B}_single_calls_in_every_slot={equal} "
              f"idx_mismatch_vs_plain={mismatch} max_abs_err={err:.3e} "
              f"rows>=qcnt_empty={dead_ok} item_without_targets_empty="
              f"{empty_ok} ms={ms:.4f} (device, graph of {GRAPH_CALLS} "
              f"batched calls) {B}_single_calls_ms={single_ms:.4f} "
              f"ratio={ms / single_ms:.3f} bound_ms={bound:.5f} (the sum of "
              f"the items' single bounds) bound_share={bound / ms:.4f} "
              f"[{card}]", flush=True)
        check(equal, f"{label}: the batch differs from {B} single calls")
        check(mismatch == 0 and err <= SQD_ATOL and dead_ok and empty_ok,
              f"{label}: the batch differs from the plain version")
        out[label] = dict(ms=ms, single_ms=single_ms, bound_ms=bound)
    return out


BATCH_SCANS = 320         # the drive the three windows are cut from
BATCH_WINDOW = 240
BATCH_STARTS = (0, 40, 80)
BATCH_LAPS = 1.6          # 1.2 laps a window: each revisits its first 0.2
# The merge's gates.  Placement of sequences 1 and 2 in sequence 0's start
# frame: the mean below MERGE_MEAN_M and MERGE_RATIO x the unmerged error.
# That error holds sequence 0's own drift in its start frame, which is
# bounded apart; the merged map rigidly aligned to ground truth shows how
# well the chains sit on each other, apart from that drift.
MERGE_MEAN_M = 1.0
MERGE_RATIO = 0.2
MERGE_SEQ0_MEAN_M = 1.0
MERGE_ALIGNED_MEAN_M = 0.5
MERGE_ALIGNED_MAX_M = 1.5


def make_batch_drive(cfg, card):
    """The batch cell's drive: 320 scans of a skewed figure-8 over 1.6
    laps, noise 0.01, seed 11, capture order; rays cast in worker
    processes.  A 240-scan window covers 1.2 laps, so every window drives
    its first 48 scans' course again at its end (~13 keyframes, four loop
    checks).  At the headline drive's 1.05 laps a window, the revisit is
    12 scans long and the window from scan 80 closed no loop, in the batch
    nor in one SlamEngine; this drive is 14 % faster a scan than the
    headline's."""
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, BATCH_SCANS, trajectory="figure8", radius=30.0,
        loops=BATCH_LAPS, noise=0.01, seed=11, shuffle=False, skew=True,
        workers=workers)
    print(f"data: batch drive, {BATCH_SCANS} scans (figure-8, radius 30 m, "
          f"{BATCH_LAPS} laps), windows of {BATCH_WINDOW} from scans "
          f"{BATCH_STARTS}, host generation {time.perf_counter() - t0:.2f} s "
          f"in {workers} processes [{card}]", flush=True)
    return scans, valids, gt


def _seq(state, s):
    """Sequence s of a leading-S state tuple (views)."""
    if isinstance(state, torch.Tensor):
        return state[s]
    return type(state)(*(_seq(leaf, s) for leaf in state))


def batch_starts(S: int) -> tuple:
    """Window starts for S sequences: BATCH_STARTS for 3, else spread
    evenly over the same 0-80 (every window covers 1.2 laps and revisits
    its start, so no more rays are cast)."""
    if S == len(BATCH_STARTS):
        return BATCH_STARTS
    return tuple(int(x) for x in np.linspace(BATCH_STARTS[0],
                                             BATCH_STARTS[-1], S).round())


def run_batch_path(cfg, pts_all, msk_all, gt_all, single, card, S=3,
                   eager=False, beside=""):
    """``BatchEngine(cfg, n_seq=S)`` on the card over S 240-scan windows
    of the batch drive (``batch_starts``), loop closure on, its three
    batched steps as graph replays (``eager=True``: op by op, the loop
    tick's gates host reads).  ``single`` is the loop path's summary in
    this call; ``beside`` says what else runs meanwhile.  Returns (kNN
    launches of the drive, the engine, a summary)."""
    from sc_lego_loam_tpu_torch.parallel import batch as pbatch

    starts, n = batch_starts(S), BATCH_WINDOW
    mode = "eager" if eager else "graphed"
    label = f"batch path S={S} ({mode}{', ' + beside if beside else ''})"
    window = torch.tensor(starts, device="cuda")
    gts = [gt_all[s0:s0 + n] for s0 in starts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    engine = pbatch.BatchEngine(cfg, n_seq=S, eager=eager)
    engine.trace.on()           # its host spans are read after the drive
    check(engine.device.type == "cuda", "the default device is not the card")
    check((engine.graphs is None) == eager, f"{label}: graphs {eager=}")
    reset_counts()

    rec: list = []
    spans = {name: [] for name in ("perception", "mapping", "descriptors",
                                   "loop")}
    ticks = []

    def watch(attr, name):
        """Where the vmapped callables ran (eagerly, or at a graph's
        warm-up and capture): their functorch fallback warnings."""
        inner = getattr(engine, attr)

        def watched(*a, **kw):
            n0 = len(rec)
            out = inner(*a, **kw)
            spans[name].append((n0, len(rec)))
            return out
        setattr(engine, attr, watched)

    originals = {attr: getattr(engine, attr)
                 for attr in ("_perception", "_mapping", "_descriptors")}
    watch("_perception", "perception")
    watch("_mapping", "mapping")
    watch("_descriptors", "descriptors")
    tick = engine._loop_tick

    def watched_tick(*a):
        n0, k0 = len(rec), k1_mark()
        calls = 0 if eager else engine.graphs[2].calls
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        h0 = time.perf_counter()
        out = tick(*a)
        host_ms = 1e3 * (time.perf_counter() - h0)
        ev1.record()
        spans["loop"].append((n0, len(rec)))
        ticks.append(dict(ev0=ev0, ev1=ev1, host_ms=host_ms, k0=k0,
                          k1=k1_mark(), w0=n0, w1=len(rec),
                          kind="replay" if eager or calls else "capture"))
        return out

    engine._loop_tick = watched_tick

    def step(i):
        engine.process_scans(pts_all[window + i], msk_all[window + i],
                             t=i * 0.1)

    with warnings.catch_warnings(record=True) as caught, \
            CaptureWatch() as captures:
        rec = captures.rec = caught
        warnings.simplefilter("always")
        for i in range(LOOP_WARMUP):
            step(i)
        torch.cuda.synchronize()
        w_start = len(rec)
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i in range(LOOP_WARMUP, n):
            step(i)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()          # the window's one final sync
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # Functorch per-sample fallbacks (over the whole drive), by stage.
    def fallbacks(name):
        ids = set()
        for a, b in spans[name]:
            ids.update(range(a, b))
        return sorted({str(rec[j].message).split(" because")[0][:200]
                       for j in ids if "performance drop" in
                       str(rec[j].message)})

    drops = {name: fallbacks(name) for name in spans}
    # Host syncs of the timed window: inside loop ticks, and elsewhere
    # (the graph captures' own apart).
    in_tick = set()
    for a, b in spans["loop"]:
        in_tick.update(range(max(a, w_start), b))
    timed_rec = list(enumerate(rec))[w_start:]
    syncs = [(j, w) for j, w in timed_rec if "synchroniz" in str(w.message)
             and id(w) not in captures.ids]
    loop_syncs = [w for j, w in syncs if j in in_tick]
    other_syncs = [w for j, w in syncs if j not in in_tick]

    timed = n - LOOP_WARMUP
    steps_per_s = timed / wall
    seq_fps = S * steps_per_s
    traj = engine.trajectory_array()
    kf_n = engine.map.kf.count.tolist()
    closed = engine.loops_closed.tolist()
    print(f"{label} (BatchEngine, default_config, loop closure on): "
          f"windows={starts} scans={n} warmup="
          f"{LOOP_WARMUP} batched_steps_per_s={steps_per_s:.3f} "
          f"sequence_scans_per_s={seq_fps:.3f} (single SlamEngine loop path "
          f"in this call: {single['scans_per_s']:.3f} scans/s; ratio "
          f"{seq_fps / single['scans_per_s']:.3f}) peak_mem_bytes={peak} "
          f"(of which {held} held before the path began) keyframes={kf_n} "
          f"mapping_ticks={engine._map_ticks} loop_ticks={engine.loop_ticks} "
          f"knn_launches_k5={launches[5]} knn_launches_k1={launches[1]} "
          f"loops_closed={closed} [{card}]", flush=True)
    stages = engine.trace.summary(skip_first=LOOP_WARMUP)
    print(f"{label} stages, host ms to launch (mean): " + " ".join(
        f"{name}={1e3 * st['mean']:.2f} (n={st['n']})"
        for name, st in sorted(stages.items())) + f" [{card}]", flush=True)
    if not eager:
        print(f"{label} graphs: {graphs.summary(engine.graphs)} "
              f"graph_captures={captures.captures} [{card}]", flush=True)
    for t in ticks:
        t["ms"] = t["ev0"].elapsed_time(t["ev1"])
        t["syncs"] = sum(1 for j in range(t["w0"], t["w1"])
                         if "synchroniz" in str(rec[j].message)
                         and id(rec[j]) not in captures.ids)
        t["k1"] = k1_between(t["k0"], t["k1"])
    replays = [t for t in ticks if t["kind"] == "replay"]
    verified = [t for t in replays if t["k1"] > 0]
    idle = [t for t in replays if t["k1"] == 0]
    for name, group in (("with a verification", verified),
                        ("no candidate", idle)):
        ms = [t["ms"] for t in group]
        print(f"{label} loop ticks {name}: n={len(group)} mean_ms_cuda_"
              f"events={np.mean(ms) if ms else float('nan'):.3f} "
              f"max_ms_host={max([t['host_ms'] for t in group], default=0):.3f}"
              f" mean_host_syncs="
              f"{np.mean([t['syncs'] for t in group]) if group else 0:.2f} "
              f"mean_k1_launches="
              f"{np.mean([t['k1'] for t in group]) if group else 0:.2f} "
              f"[{card}]", flush=True)
    print(f"{label} host syncs in the {timed} timed steps: loop_ticks="
          f"{len(loop_syncs)} elsewhere={len(other_syncs)} graph_captures="
          f"{captures.captures} ({len(other_syncs) / timed:.2f} a step; the "
          f"single loop path: {single['syncs_elsewhere']}) [{card}]",
          flush=True)
    print_syncs(f"{label} loop tick", loop_syncs)
    print_syncs(f"{label} elsewhere", other_syncs)
    for name, found in drops.items():
        print(f"{label} functorch per-sample fallbacks in {name}: "
              f"{len(found)} {found} [{card}]", flush=True)

    ates, prs = [], []
    for s in range(S):
        kf = _seq(engine.map.kf, s)
        ate = evaluate.ate_rmse(traj[s], gts[s])
        k = kf_n[s]
        kf_pos = kf.poses6[:k, 3:6].cpu().numpy()
        at = np.clip(np.round(kf.times[:k].cpu().numpy() / 0.1).astype(int),
                     0, n - 1)
        kf_est = np.tile(np.eye(4), (k, 1, 1))
        kf_est[:, :3, 3] = kf_pos
        kf_est[:, :3, :3] = se3.pose6_to_mat(kf.poses6[:k])[:, :3, :3] \
            .cpu().numpy()
        ate_graph = evaluate.ate_rmse(kf_est, gts[s][at])
        shim = type("Seq", (), {})()
        shim.loops = _seq(engine.loops, s)
        shim.m = type("M", (), {"kf": kf})()
        pr = evaluate.loop_precision_recall(shim, gts[s], cfg,
                                            tol_m=FACTOR_TOL_M)
        ates.append((ate, ate_graph))
        prs.append(pr)
        print(f"{label} sequence {s} (scans {starts[s]}-"
              f"{starts[s] + n - 1}): ate_m={ate:.4f} (fused, as "
              f"published) ate_keyframe_graph_m={ate_graph:.4f} keyframes={k} "
              f"loops_closed={closed[s]} factors accepted={pr['accepted']} "
              f"true={pr['true_factors']} precision={pr['precision']} "
              f"recall={pr['recall']} [{card}]", flush=True)

    check(traj.shape == (S, n, 4, 4) and bool(np.isfinite(traj).all()),
          f"{label}: trajectories {traj.shape} not finite or misshapen")
    for s in range(S):
        check(ates[s][0] < ATE_BAR and ates[s][1] < ATE_BAR,
              f"{label} sequence {s}: ATE {ates[s]} >= {ATE_BAR} m")
        check(closed[s] >= 1, f"{label} sequence {s}: no loop closed")
        check(prs[s]["accepted"] == 0 or prs[s]["precision"] == 1.0,
              f"{label} sequence {s}: accepted factors not all true: "
              f"{prs[s]}")
    check(launches[5] > 0 and launches[1] > 0,
          f"{label}: a kNN instantiation never launched: {launches}")
    check(launches[5] == expected_k5(cfg, engine._map_ticks),
          f"{label}: k=5 calls {launches[5]}, expected one batched call "
          f"per single-sequence call")
    for name in ("perception", "mapping", "descriptors"):
        check(not drops[name], f"{label}: functorch fallbacks in {name}: "
              f"{drops[name]}")
    # Graphed, the whole window holds no sync but the captures' own; eager,
    # none outside the loop ticks.
    stray = stray_syncs(other_syncs + ([] if eager else loop_syncs))
    check(not stray, f"{label}: a host sync in the timed window: "
          + ", ".join(sorted({where(w) for w in stray})))
    if not eager:
        check(all(g.captured and g.replays > 0 for g in engine.graphs),
              f"{label}: the steps did not run as CUDA graph replays")
    del engine._loop_tick
    for attr, fn in originals.items():
        setattr(engine, attr, fn)
    summary = dict(seq_fps=seq_fps, steps_per_s=steps_per_s, peak=peak - held,
                   ates=ates, drops=drops, traj=traj, closed=closed, prs=prs,
                   loops=[x.cpu().numpy() for x in engine.loops],
                   S=S, starts=starts)
    return launches, engine, summary


def compare_batches(graphed, eager, card):
    """The graphed and the eager S=3 batch from the same scans: the same
    loops per sequence, every factor true, trajectories bit-equal or within
    BATCH_EQUAL_M."""
    same = np.array_equal(graphed["traj"], eager["traj"])
    d = float(np.abs(graphed["traj"][..., :3, 3]
                     - eager["traj"][..., :3, 3]).max())
    same_loops = graphed["closed"] == eager["closed"] and all(
        np.array_equal(a, b) for a, b in zip(graphed["loops"],
                                             eager["loops"]))
    print(f"batch S=3 graphed against eager in this call: trajectories "
          f"bit-equal={same} (max |d position| {d:.3e} m) loops_closed "
          f"{graphed['closed']} / {eager['closed']} loop banks equal="
          f"{same_loops} sequence_scans_per_s {graphed['seq_fps']:.3f} / "
          f"{eager['seq_fps']:.3f} (ratio "
          f"{graphed['seq_fps'] / eager['seq_fps']:.3f}) [{card}]",
          flush=True)
    check(graphed["closed"] == eager["closed"],
          "batch S=3: graphed and eager closed different loops")
    check(same or d < BATCH_EQUAL_M, f"batch S=3: graphed and eager "
          f"trajectories {d} m apart")


def run_batch_sizes(cfg, pts_all, msk_all, gt_all, single, card):
    """The graphed batch at every S of BATCH_SIZES past 3, one engine at a
    time (each freed before the next); an S whose banks do not fit the
    card falls back to BATCH_FALLBACK.  Returns {S: (launches, summary)}."""
    out = {}
    for S in BATCH_SIZES:
        if S == len(BATCH_STARTS):
            continue
        try:
            launches, engine, summary = run_batch_path(
                cfg, pts_all, msk_all, gt_all, single, card, S=S)
        except torch.cuda.OutOfMemoryError as err:
            free_memory()
            print(f"batch path S={S}: does not fit the card ({err}); "
                  f"S={BATCH_FALLBACK} instead [{card}]", flush=True)
            S = BATCH_FALLBACK
            launches, engine, summary = run_batch_path(
                cfg, pts_all, msk_all, gt_all, single, card, S=S)
        out[S] = (launches, summary)
        del engine
        free_memory()
    for S, (_, sm) in sorted(out.items()):
        print(f"batch S={S} (graphed): sequence_scans_per_s="
              f"{sm['seq_fps']:.3f} ratio_to_single="
              f"{sm['seq_fps'] / single['scans_per_s']:.3f} peak_mem_bytes="
              f"{sm['peak']} loops_closed={sm['closed']} factors_true="
              f"{[p['true_factors'] for p in sm['prs']]} ate_m="
              f"{[round(a[0], 4) for a in sm['ates']]} [{card}]", flush=True)
    return out


def run_merge(cfg, engine, gt_all, card):
    """The cross-sequence merge on the batch path's end state:
    ``find_cross_loops`` and ``verify_cross_loops`` for pairs (0, 1) and
    (0, 2), ``anchor_sequence`` of 1 and 2 from each one's best accepted
    factor, one ``merge_solve`` of the three chains with the intra- and
    cross-sequence factors in global ids.  Placement errors of sequences 1
    and 2 against ground truth in sequence 0's start frame."""
    from sc_lego_loam_tpu_torch.parallel import batch as pbatch

    S, n = len(BATCH_STARTS), BATCH_WINDOW
    K = cfg.cap.max_keyframes
    kfs = [_seq(engine.map.kf, s) for s in range(S)]
    banks = [_seq(engine.bank, s) for s in range(S)]
    counts = engine.map.kf.count.tolist()

    def world_gt(s, kf):
        """World-frame ground truth of sequence s's keyframes."""
        at = np.clip(np.round(kf.times[:counts[s]].cpu().numpy() / 0.1)
                     .astype(int), 0, n - 1)
        return gt_all[BATCH_STARTS[s] + at]

    gt_kf = [world_gt(s, kfs[s]) for s in range(S)]
    frame0 = np.linalg.inv(gt_all[BATCH_STARTS[0]])
    li, lj, lz = [], [], []
    for s in range(S):                    # intra-sequence factors
        lo = _seq(engine.loops, s)
        m = min(int(lo.count), lo.i.shape[0])
        li += (s * K + lo.i[:m].long()).tolist()
        lj += (s * K + lo.j[:m].long()).tolist()
        lz += list(lo.z[:m].cpu().numpy())
    n_intra = len(li)
    poses6 = engine.map.kf.poses6.clone()
    for s in (1, 2):
        t0 = time.perf_counter()
        ia, ib, dist, yaw, ok = pbatch.find_cross_loops(cfg, banks[0],
                                                        banks[s])
        Z, fit, acc = pbatch.verify_cross_loops(cfg, kfs[0], kfs[s], ia, ib,
                                                yaw, ok)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        ia, ib = ia.cpu().numpy(), ib.cpu().numpy()
        Zn, acc, fit = Z.cpu().numpy(), acc.cpu().numpy(), fit.cpu().numpy()
        true = []
        for p in range(len(ia)):
            z_gt = np.linalg.inv(gt_kf[0][ia[p]]) @ gt_kf[s][ib[p]]
            true.append(bool(np.linalg.norm(Zn[p][:3, 3] - z_gt[:3, 3])
                             < FACTOR_TOL_M))
        true = np.asarray(true)
        print(f"merge pair (0, {s}): candidates={int(ok.sum())} of "
              f"{len(ia)} (dist {dist.cpu().numpy().round(3).tolist()}) "
              f"accepted={int(acc.sum())} true_among_accepted="
              f"{int((acc & true).sum())} true_among_candidates="
              f"{int((ok.cpu().numpy() & true).sum())} fitness="
              f"{fit.round(3).tolist()} find+verify_s={took:.3f} [{card}]",
              flush=True)
        check(acc.sum() >= 1, f"merge pair (0, {s}): no cross factor")
        check(bool(true[acc].all()), f"merge pair (0, {s}): a false cross "
              f"factor was accepted")
        for p in np.flatnonzero(acc):
            li.append(int(ia[p]))
            lj.append(s * K + int(ib[p]))
            lz.append(Zn[p])
        best = int(np.flatnonzero(acc)[np.argmin(fit[acc])])
        poses6[s] = pbatch.anchor_sequence(
            poses6[s], engine.map.kf.count[s], kfs[0].poses6[int(ia[best])],
            Z[best], torch.tensor(int(ib[best]), device="cuda"))

    L = cfg.posegraph.max_loops
    check(len(li) <= L, f"merge: {len(li)} factors > {L} slots")
    loops = posegraph.init_loops(cfg, "cuda")
    m = len(li)
    loops = posegraph.LoopFactors(
        i=loops.i.index_copy(0, torch.arange(m, device="cuda"),
                             torch.tensor(li, dtype=torch.int32,
                                          device="cuda")),
        j=loops.j.index_copy(0, torch.arange(m, device="cuda"),
                             torch.tensor(lj, dtype=torch.int32,
                                          device="cuda")),
        z=loops.z.index_copy(0, torch.arange(m, device="cuda"),
                             torch.from_numpy(np.stack(lz)).cuda()),
        count=torch.full((), m, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = pbatch.merge_solve(cfg, poses6, engine.map.kf.count,
                                engine.map.kf.odom_z, loops)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0

    def placement(p6, s, align=None):
        """Keyframe position errors of sequence s in sequence 0's start
        frame (after the rigid ``align`` (R, t) when given)."""
        est = p6[s, :counts[s], 3:6].cpu().numpy().astype(np.float64)
        if align is not None:
            est = est @ align[0].T + align[1]
        truth = (frame0[None] @ gt_kf[s])[:, :3, 3]
        return np.linalg.norm(est - truth, axis=-1)

    # The merged map as a whole, rigidly aligned to ground truth (what ATE
    # does to one trajectory): how well the sequences sit on each other,
    # apart from sequence 0's own drift in its start frame.
    every = np.concatenate([merged[s, :counts[s], 3:6].cpu().numpy()
                            for s in range(S)]).astype(np.float64)
    truth = np.concatenate([(frame0[None] @ gt_kf[s])[:, :3, 3]
                            for s in range(S)])
    align = evaluate.umeyama_alignment(every, truth)
    e0_u, e0_m = placement(engine.map.kf.poses6, 0), placement(merged, 0)
    out = {}
    for s in (1, 2):
        e_m, e_u = placement(merged, s), placement(engine.map.kf.poses6, s)
        e_a = placement(merged, s, align)
        out[s] = (e_m.mean(), e_u.mean(), e_a.mean(), e_a.max())
        print(f"merge sequence {s}: placement error in sequence 0's start "
              f"frame, merged mean={e_m.mean():.4f} max={e_m.max():.4f} m, "
              f"unmerged mean={e_u.mean():.4f} max={e_u.max():.4f} m; the "
              f"merged map rigidly aligned to ground truth: mean="
              f"{e_a.mean():.4f} max={e_a.max():.4f} m [{card}]", flush=True)
    print(f"merge_solve: {S} chains, {sum(counts)} keyframes of {S * K} "
          f"nodes, {m} factors (in all, {n_intra} of them intra-sequence), "
          f"seconds={solve_s:.3f}; sequence 0 in its own start frame: mean "
          f"error {e0_u.mean():.4f} m before the merge, {e0_m.mean():.4f} m "
          f"after, {placement(merged, 0, align).mean():.4f} m aligned "
          f"[{card}]", flush=True)
    e0 = e0_m.mean()
    check(e0 < MERGE_SEQ0_MEAN_M, f"merge: sequence 0's own mean error in "
          f"its start frame {e0} m >= {MERGE_SEQ0_MEAN_M} m")
    for s in (1, 2):
        m_mean, u_mean, a_mean, a_max = out[s]
        check(m_mean < MERGE_MEAN_M and m_mean < MERGE_RATIO * u_mean,
              f"merge sequence {s}: merged mean {m_mean} m, against "
              f"{MERGE_MEAN_M} m and {MERGE_RATIO} x unmerged {u_mean} m")
        check(a_mean < MERGE_ALIGNED_MEAN_M and a_max < MERGE_ALIGNED_MAX_M,
              f"merge sequence {s}: aligned placement mean {a_mean} m max "
              f"{a_max} m, against {MERGE_ALIGNED_MEAN_M} / "
              f"{MERGE_ALIGNED_MAX_M} m")
    return out


def batch_step_launches(batch, single, pts_all, msk_all, card):
    """Kernel launches of one batched perception step and one batched
    mapping tick (three sequences) beside the single-sequence functions
    on one sequence, by ``torch.profiler`` after the drives."""
    from sc_lego_loam_tpu_torch.parallel import batch as pbatch

    cfg = batch.config
    window = torch.tensor(BATCH_STARTS, device="cuda") + BATCH_WINDOW - 1
    pts, msk = pts_all[window], msk_all[window]
    odo, pose, out_pts, out_mask = batch._perception(pts, msk, batch.odo)
    odo1 = _seq(batch.odo, 0)
    o1, p1, op1, om1 = pipeline._odo_perception(cfg, pts[0], msk[0], odo1)
    t = torch.full((), 24.0, device="cuda")
    map1 = _seq(batch.map, 0)
    parts = [
        ("batched perception step, 3 sequences",
         lambda: batch._perception(pts, msk, batch.odo)),
        ("single-sequence perception (_odo_perception)",
         lambda: pipeline._odo_perception(cfg, pts[0], msk[0], odo1)),
        ("batched mapping tick, 3 sequences (rows, not written)",
         lambda: batch._mapping(batch.map, batch.last_kf_odom, pose,
                                odo.corner_last.xyz, odo.corner_last.mask,
                                odo.surf_last.xyz, odo.surf_last.mask,
                                out_pts, out_mask, t)),
        ("single-sequence mapping tick (rows, not written)",
         lambda: pbatch._map_one(cfg, map1, batch.last_kf_odom[0], p1,
                                 o1.corner_last.xyz, o1.corner_last.mask,
                                 o1.surf_last.xyz, o1.surf_last.mask, op1,
                                 om1, t)),
    ]
    got = measure_parts("batch step", parts, card)
    names = [p[0] for p in parts]
    step_b = got[names[0]]["launches"] + got[names[2]]["launches"] / 3
    step_1 = got[names[1]]["launches"] + got[names[3]]["launches"] / 3
    print(f"launches per batched step (perception + a third of a mapping "
          f"tick): {step_b:.0f} for 3 sequences against {step_1:.0f} for "
          f"one (ratio {step_b / step_1:.3f}) [{card}]", flush=True)
    return got



def run_repeatable(cfg, pts, msk, loop_engine, card):
    """Fault 1 closed, and the graphs equal to the op-by-op path: two eager
    engines (``eager=True``) over the loop drive's first REPEAT_SCANS scans
    agree bit for bit (both trajectories, keyframe poses and count, loop
    bank, kernel launches), a graphed engine (the default) agrees with
    them, and so do the loop path's first published poses.  Then
    DET_SCANS eager scans under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` list what torch still calls nondeterministic (that
    mode swaps some kernels for others, so its run is not compared).
    Returns the graphed engine's published trajectory."""
    n = REPEAT_SCANS

    def drive(eager, scans=n):
        torch.cuda.synchronize()
        reset_counts()
        eng = SlamEngine(cfg, eager=eager)
        t0 = time.perf_counter()
        for i in range(scans):
            eng.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kf_n = int(eng.m.kf.count)
        out = dict(traj=eng.trajectory_array(),
                   raw=eng.trajectory_array(retro_correct=False),
                   kf=eng.m.kf.poses6[:kf_n].cpu().numpy(), kf_n=kf_n,
                   loops=[x.cpu().numpy() for x in eng.m.loops],
                   launches=launch_counts())
        return eng, out, wall

    def same(a, b):
        return (a["kf_n"] == b["kf_n"] and a["launches"] == b["launches"]
                and all(np.array_equal(a[k], b[k])
                        for k in ("traj", "raw", "kf"))
                and all(np.array_equal(x, y)
                        for x, y in zip(a["loops"], b["loops"])))

    _, e1, w1 = drive(True)
    _, e2, w2 = drive(True)
    g_eng, g, wg = drive(False)
    loop_raw = loop_engine.trajectory_array(retro_correct=False)[:n]
    repeat, graphed = same(e1, e2), same(g, e1)
    loop_same = bool(np.array_equal(loop_raw, g["raw"]))
    d_pos = float(np.abs(e1["raw"] - e2["raw"]).max())
    print(f"repeatable: two eager engines over the first {n} scans "
          f"bit-equal={repeat} (max |d pose entry| {d_pos:.3e}; keyframes "
          f"{e1['kf_n']} / {e2['kf_n']}) "
          f"s={w1:.1f} / {w2:.1f}; graphed engine bit-equal to them="
          f"{graphed} s={wg:.1f}; loop path's first {n} published poses "
          f"bit-equal={loop_same}; launches eager {e1['launches']} graphed "
          f"{g['launches']} [{card}]", flush=True)
    print(f"repeatable graphs: {graphs.summary(g_eng.graphs)} [{card}]",
          flush=True)
    check(repeat, "repeatable: two eager runs differ (fault 1 is open)")
    check(graphed, "repeatable: the graphed engine differs from the eager")
    check(loop_same, "repeatable: the loop path's first poses differ from "
          "the graphed engine's")
    del g_eng

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            drive(True, DET_SCANS)
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = Counter(
        f"{where(w)}: {str(w.message).splitlines()[0][:160]}" for w in rec
        if "deterministic" in str(w.message))
    print(f"repeatable: {DET_SCANS} eager scans under torch's deterministic "
          f"mode (warn_only): {len(flagged)} places torch calls "
          f"nondeterministic [{card}]", flush=True)
    for at, count in flagged.most_common():
        print(f"  nondeterministic x{count}: {at}", flush=True)
    return g["raw"]


# ---------------------------------------------------------------------------
# The mesh paths (parallel/mesh.py, parallel/retrieval.py, every ``mesh``
# argument).  The machine has one card, so M2 and M3 run two processes on
# it, joined by gloo, which runs all_reduce / broadcast on CUDA tensors
# (NCCL refuses two ranks on one card); M1 is one process on NCCL.

MESH1_SCANS = REPEAT_SCANS  # M1: the headline drive's first scans
MESH1_FLOOR_M = 5e-3      # M1's tolerance is max(2 x run-to-run, this)
MESH2_WARMUP = 6
MESH3_STEPS = 12          # M3: the batch drive's first steps, windows 0, 1
MESH3_TOL_M = 0.05        # M3 against one process at the same batch size:
MESH3_TOL_DEG = 0.5       # max(2 x the run-to-run spread, these)
MESH3_BATCH_M = 0.14      # ... at another batch size: twice the largest of
MESH3_BATCH_DEG = 0.75    # three runs on the card (0.068 m, 0.375 deg)
SOLVE_TOL = 1e-3          # sharded against unsharded re-solve (poses6)


def _pose_diff(a, b):
    """Largest position (m) and rotation (deg) difference of two (N,4,4)."""
    dpos = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    R = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    c = np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return dpos, float(np.degrees(np.arccos(c)).max())


def run_mesh1(cfg, pts, msk, loop_engine, plain, card):
    """M1: ``SlamEngine(cfg, mesh=make_mesh(1, 1))`` in this process, NCCL
    at world size 1 (every collective an identity), over the drive's
    first scans, held against the loop path's first published poses; the
    tolerance is the card's run-to-run spread, from a second plain run
    (``plain``, the repeatable phase's graphed engine over the same
    scans)."""
    import torch.distributed as dist
    from sc_lego_loam_tpu_torch.parallel import mesh as pmesh

    n = MESH1_SCANS

    def drive(mesh):
        eng = SlamEngine(cfg, mesh=mesh)
        for i in range(n):
            eng.process_scan(pts[i], msk[i], t=i * 0.1)
        return eng, eng.trajectory_array(retro_correct=False)

    ref = loop_engine.trajectory_array(retro_correct=False)[:n]
    spread = _pose_diff(plain[:n], ref)
    mesh = pmesh.make_mesh(1, 1)
    check(dist.get_backend() == "nccl", "M1 is not on NCCL")
    pmesh.reset_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng, traj = drive(mesh)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(pmesh.stats)
    check(eng.shard is not None and eng.shard.size == 1, "M1 has no mesh")
    dist.destroy_process_group()
    diff = _pose_diff(traj, ref)
    tol = max(2 * spread[0], MESH1_FLOOR_M)
    print(f"mesh M1 (world size 1, NCCL, kf mesh of 1): scans={n} "
          f"s={wall:.1f} max_d_pos_m={diff[0]:.3e} max_d_rot_deg="
          f"{diff[1]:.3e} against the loop path's first poses; a second "
          f"plain run: {spread[0]:.3e} m / {spread[1]:.3e} deg; tolerance "
          f"{tol:.3e} m; collectives={stats.get('calls', 0)} "
          f"bytes={stats.get('bytes', 0)} knn_launches={launches} "
          f"[{card}]", flush=True)
    check(bool(np.isfinite(traj).all()), "M1: trajectory is not finite")
    check(diff[0] <= tol, f"M1: {diff[0]} m from the plain engine, over "
          f"{tol} m")
    return launches


def mesh2_rank(info, data):
    """M2, one rank: ``SlamEngine(default_config(), mesh=...)`` over the
    whole drive with half of the banks; then sharded retrieval and the
    sharded re-solve on the engine's own banks against their unsharded
    forms.  Writes ``rank<r>.npz`` to ``data``."""
    from sc_lego_loam_tpu_torch.parallel import mesh as pmesh, retrieval

    r = info["rank"]
    cfg = default_config()
    mesh = pmesh.make_mesh(info["world"], 1)
    pts = torch.from_numpy(np.load(os.path.join(data, "scans.npy"))).cuda()
    msk = torch.from_numpy(np.load(os.path.join(data, "valids.npy"))).cuda()
    gt = np.load(os.path.join(data, "gt.npy"))
    engine = SlamEngine(cfg, mesh=mesh)
    check(engine.device.type == "cuda", "M2: a rank is not on the card")
    ticks = {"mapping": [], "loop": []}

    def watch(name):
        inner = getattr(pipeline, name + "_step")

        def watched(*a, **kw):
            c0, b0 = pmesh.stats["calls"], pmesh.stats["bytes"]
            out = inner(*a, **kw)
            ticks[name].append((pmesh.stats["calls"] - c0,
                                pmesh.stats["bytes"] - b0))
            return out
        setattr(pipeline, name + "_step", watched)
        return inner

    inners = {name: watch(name) for name in ticks}
    torch.cuda.synchronize()
    reset_counts()
    pmesh.reset_stats()
    try:
        for i in range(MESH2_WARMUP):
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH2_WARMUP, len(gt)):
            engine.process_scan(pts[i], msk[i], t=i * 0.1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, inner in inners.items():
            setattr(pipeline, name + "_step", inner)
    launches = launch_counts()
    stats = dict(pmesh.stats)
    traj = engine.trajectory_array()
    pr = evaluate.loop_precision_recall(engine, gt, cfg, tol_m=FACTOR_TOL_M)
    bank_bytes = sum(leaf.numel() * leaf.element_size()
                     for path, leaf in export.state_leaves(engine.m)
                     if path in pipeline.SHARDED_LEAVES)
    peak = torch.cuda.max_memory_allocated()

    # Sharded retrieval against ``detect`` over the whole bank, every 16th
    # keyframe's descriptor as the query, and the newest one's.
    bank = engine.bank
    whole = scan_context.DescriptorBank(
        pmesh.gather_full(bank.desc, mesh), pmesh.gather_full(bank.ringkey,
                                                              mesh),
        bank.count)
    n_kf = int(bank.count)
    queries = sorted(set(range(0, n_kf, 16)) | {n_kf - 1})
    d_dist, hits = 0.0, 0
    for q in queries:
        a = scan_context.detect(cfg, whole, whole.desc[q])
        b = retrieval.detect_sharded(cfg, mesh, bank.desc, bank.count,
                                     whole.desc[q])
        check(int(a[0]) == int(b[0]), f"M2: sharded retrieval idx {int(b[0])} "
              f"!= {int(a[0])} for query {q}")
        d_dist = max(d_dist, abs(float(a[1]) - float(b[1])))
        hits += int(a[0]) >= 0
    check(d_dist <= 1e-5, f"M2: sharded retrieval dist differs by {d_dist}")

    # The sharded re-solve of the engine's graph with its loop factors,
    # against two unsharded solves (their spread: the scatter-add of the
    # update rounds run to run on the card).
    kf, loops = engine.m.kf, engine.m.loops
    args = (cfg, kf.poses6, kf.count, kf.odom_z, loops)
    sharded = posegraph.solve(*args, mesh=mesh)
    plain = [posegraph.solve(*args) for _ in range(2)]
    n = int(kf.count)
    d_solve = float((sharded - plain[0])[:n].abs().max())
    d_plain = float((plain[1] - plain[0])[:n].abs().max())
    check(d_solve <= SOLVE_TOL, f"M2: sharded solve {d_solve} from the "
          f"unsharded one")
    np.savez(os.path.join(data, f"rank{r}.npz"),
             traj=traj, kf=n_kf, loops_closed=int(engine.loops_closed),
             accepted=pr["accepted"], true=pr["true_factors"],
             precision=-1.0 if pr["precision"] is None else pr["precision"],
             scans_per_s=(len(gt) - MESH2_WARMUP) / wall,
             bank_bytes=bank_bytes, peak=peak, k5=launches[5],
             k1=launches[1], symeig=launches["symeig"],
             calls=stats.get("calls", 0),
             bytes=stats.get("bytes", 0), map_ticks=np.array(ticks["mapping"]),
             loop_ticks=np.array(ticks["loop"]).reshape(-1, 2),
             d_dist=d_dist, queries=len(queries), hits=hits,
             d_solve=d_solve, d_plain=d_plain, n_loops=int(loops.count))


def run_mesh2(scans, valids, gt, loop_engine, lidar, card, background):
    """M2: two processes on the one card (gloo on CUDA tensors), a 'kf'
    mesh of 2, ``default_config()`` at full width over the whole drive,
    each process holding half of the banks.  Gates against the loop
    path's single engine in this call, as tests/test_engine_mesh.py sets
    them.  ``background`` runs in this process meanwhile.  Returns each
    rank's kNN launches, and what ``background`` returned."""
    from sc_lego_loam_tpu_torch.tools.dryrun_multichip import run_ranks

    d = tempfile.mkdtemp(prefix="mesh2_")
    for name, x in (("scans", scans), ("valids", valids), ("gt", gt)):
        np.save(os.path.join(d, name + ".npy"), x)
    t0 = time.perf_counter()
    m1 = run_ranks(2, "chip_smoke:mesh2_rank", dict(data=d), device="cuda",
                   timeout=900, background=background)
    took = time.perf_counter() - t0
    rk = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in (0, 1)]
    for r in (0, 1):
        check(np.array_equal(rk[r]["traj"], rk[0]["traj"]),
              "M2: the ranks' trajectories differ")
    r0 = rk[0]
    est = r0["traj"]
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    ref_kf = int(loop_engine.m.kf.count)
    ref_loops = int(loop_engine.loops_closed)
    mt, lt = r0["map_ticks"], r0["loop_ticks"]
    print(f"mesh M2 (2 processes on one card, gloo on CUDA tensors, kf mesh "
          f"of 2, default_config, {len(gt)} scans): s={took:.1f} "
          f"scans_per_s={float(r0['scans_per_s']):.3f} / "
          f"{float(rk[1]['scans_per_s']):.3f} (single engine "
          f"{lidar['scans_per_s']:.3f}) keyframes={int(r0['kf'])} "
          f"(single {ref_kf}) loops_closed={int(r0['loops_closed'])} "
          f"(single {ref_loops}) factors accepted={int(r0['accepted'])} "
          f"true={int(r0['true'])} ate_m={ate:.4f} (single "
          f"{lidar['ate']:.4f}) [{card}]", flush=True)
    for r in (0, 1):
        x = rk[r]
        print(f"mesh M2 rank {r}: bank_bytes={int(x['bank_bytes'])} "
              f"peak_mem_bytes={int(x['peak'])} knn_launches k5="
              f"{int(x['k5'])} k1={int(x['k1'])} collectives="
              f"{int(x['calls'])} bytes={int(x['bytes'])} [{card}]",
              flush=True)
    print(f"mesh M2 collectives per mapping tick: calls={mt[:, 0].mean():.2f}"
          f" bytes={mt[:, 1].mean():.0f} (n={len(mt)}); per loop tick: "
          f"calls={lt[:, 0].mean() if len(lt) else 0:.2f} bytes="
          f"{lt[:, 1].mean() if len(lt) else 0:.0f} (n={len(lt)}, max "
          f"{lt[:, 1].max() if len(lt) else 0}) [{card}]", flush=True)
    print(f"mesh M2 on the engine's banks: sharded retrieval = detect for "
          f"{int(r0['queries'])} queries ({int(r0['hits'])} hits), "
          f"max_d_dist={float(r0['d_dist']):.3e}; sharded solve "
          f"({int(r0['n_loops'])} loop factors) max_d_poses6="
          f"{float(r0['d_solve']):.3e}, two unsharded solves "
          f"{float(r0['d_plain']):.3e} apart [{card}]", flush=True)
    check(bool(np.isfinite(est).all()), "M2: trajectory is not finite")
    check(abs(int(r0["kf"]) - ref_kf) <= 2, "M2: keyframe count differs")
    check(int(r0["loops_closed"]) == ref_loops, "M2: loops_closed differs")
    check(int(r0["accepted"]) >= 1 and float(r0["precision"]) == 1.0,
          "M2: accepted factors not all true")
    check(ate < max(2.0 * lidar["ate"], lidar["ate"] + 0.15),
          f"M2: ATE {ate} against the single engine's {lidar['ate']}")
    return [{5: int(rk[r]["k5"]), 1: int(rk[r]["k1"]),
             "symeig": int(rk[r]["symeig"])} for r in (0, 1)], m1


def mesh3_rank(info, data):
    """M3, one rank: ``BatchEngine(default_config(), n_seq=2, mesh=...)``,
    one sequence a rank, over the steps; rank 0 writes the gathered
    trajectories, each rank its kNN launches."""
    from sc_lego_loam_tpu_torch.parallel import batch as pbatch
    from sc_lego_loam_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(1, info["world"])
    pts = torch.from_numpy(np.load(os.path.join(data, "points.npy"))).cuda()
    msk = torch.from_numpy(np.load(os.path.join(data, "masks.npy"))).cuda()
    engine = pbatch.BatchEngine(default_config(), n_seq=2, mesh=mesh)
    check(engine.n_local == 1, "M3: a rank holds more than one sequence")
    reset_counts()
    for t in range(pts.shape[0]):
        engine.process_scans(pts[t], msk[t], t=t * 0.1)
    launches = launch_counts()
    traj = engine.trajectory_array()
    np.savez(os.path.join(data, f"rank{info['rank']}.npz"), traj=traj,
             k5=launches[5], k1=launches[1], symeig=launches["symeig"])


def run_mesh3(b_scans, b_valids, b_gt, card):
    """M3: two processes, a 'seq' mesh of 2, ``BatchEngine(n_seq=2)`` with
    one sequence each over the batch drive's first steps (windows 0 and
    1).  Run here meanwhile: one process's ``BatchEngine(n_seq=2)`` over the
    same steps, and ``BatchEngine(n_seq=1)`` over each sequence alone (a
    rank's own work in one process; sequence 0 twice, for the run-to-run
    spread).  The sharded run is held to the one-sequence runs within that
    spread (at least ``MESH3_TOL_*``), and to the two-sequence run within
    ``MESH3_BATCH_*``: a vmapped step over one sequence takes other batched
    kernels than one over two (cuSOLVER, cuBLAS), and the plane fits
    amplify the difference, as between a ``BatchEngine`` and a
    ``SlamEngine`` on identical scans."""
    from sc_lego_loam_tpu_torch.parallel import batch as pbatch
    from sc_lego_loam_tpu_torch.tools.dryrun_multichip import run_ranks

    T = MESH3_STEPS
    starts = BATCH_STARTS[:2]
    points = np.stack([b_scans[s0:s0 + T] for s0 in starts], 1)
    masks = np.stack([b_valids[s0:s0 + T] for s0 in starts], 1)
    d = tempfile.mkdtemp(prefix="mesh3_")
    np.save(os.path.join(d, "points.npy"), points)
    np.save(os.path.join(d, "masks.npy"), masks)

    def one_process(seqs):
        eng = pbatch.BatchEngine(default_config(), n_seq=len(seqs))
        p = torch.from_numpy(points[:, seqs]).cuda()
        m = torch.from_numpy(masks[:, seqs]).cuda()
        for t in range(T):
            eng.process_scans(p[t], m[t], t=t * 0.1)
        return eng.trajectory_array()

    def references():
        return (one_process([0, 1]),
                np.concatenate([one_process([0]), one_process([1])]),
                one_process([0]))

    t0 = time.perf_counter()
    both, alone, again = run_ranks(2, "chip_smoke:mesh3_rank", dict(data=d),
                                   device="cuda", timeout=900,
                                   background=references)
    took = time.perf_counter() - t0
    rk = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in (0, 1)]
    got = rk[0]["traj"]
    check(got.shape == both.shape == alone.shape == (2, T, 4, 4),
          f"M3: shape {got.shape}")
    same = [_pose_diff(got[s], alone[s]) for s in (0, 1)]
    other = [_pose_diff(got[s], both[s]) for s in (0, 1)]
    spread = _pose_diff(again[0], alone[0])
    tol = (max(MESH3_TOL_M, 2 * spread[0]), max(MESH3_TOL_DEG, 2 * spread[1]))
    gts = [b_gt[s0:s0 + T] for s0 in starts]
    ate = [evaluate.ate_rmse(got[s], gts[s]) for s in (0, 1)]
    ate_ref = [evaluate.ate_rmse(both[s], gts[s]) for s in (0, 1)]

    def pairs(xs):
        return ", ".join(f"seq {s} {p:.3e} / {q:.3e}"
                         for s, (p, q) in enumerate(xs))

    print(f"mesh M3 (2 processes, seq mesh of 2, BatchEngine(n_seq=2) one "
          f"sequence a rank, {T} steps): s={took:.1f} max_d_pos_m/deg "
          f"against BatchEngine(n_seq=1) over each sequence: {pairs(same)} "
          f"(that run twice: {spread[0]:.3e} / {spread[1]:.3e}; tolerance "
          f"{tol[0]:.3e} m / {tol[1]:.3e} deg); against one process's "
          f"BatchEngine(n_seq=2): {pairs(other)} (tolerance {MESH3_BATCH_M} "
          f"m / {MESH3_BATCH_DEG} deg); ate_m {ate[0]:.4f} / {ate[1]:.4f} "
          f"(one process {ate_ref[0]:.4f} / {ate_ref[1]:.4f}) knn_launches "
          f"per rank {[(int(x['k5']), int(x['k1'])) for x in rk]} "
          f"[{card}]", flush=True)
    check(bool(np.isfinite(got).all()), "M3: trajectory is not finite")
    for s in (0, 1):
        check(same[s][0] <= tol[0] and same[s][1] <= tol[1],
              f"M3: sequence {s} {same[s]} from its one-sequence run")
        check(other[s][0] <= MESH3_BATCH_M and other[s][1] <= MESH3_BATCH_DEG,
              f"M3: sequence {s} {other[s]} from the two-sequence run")
        check(ate[s] < max(2.0 * ate_ref[s], ate_ref[s] + 0.15),
              f"M3: sequence {s} ATE {ate[s]} against {ate_ref[s]}")
    return [{5: int(rk[r]["k5"]), 1: int(rk[r]["k1"]),
             "symeig": int(rk[r]["symeig"])} for r in (0, 1)]


def make_ordered_drive(lidar, card):
    """The first ORDERED_SCANS scans of the bench's ordered drive (block
    ``ordered``, seed 11: a 240-scan figure-8, radius 30 m, 1.05 laps, noise
    0.01, instantaneous scans in beam order): the rays cast in worker
    processes, the noise drawn scan by scan from the one rng as
    ``utils/synthetic.make_sequence`` draws it, so they equal the first
    scans of its 240."""
    import multiprocessing

    world = synthetic.default_world(seed=11)
    poses = synthetic.figure8_trajectory(240, radius=30.0, loops=1.05)
    poses = poses[:ORDERED_SCANS]
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        ranges = pool.starmap(synthetic._ranges,
                              [(world, p, lidar) for p in poses])
    rng = np.random.default_rng(12)
    scans, valids = zip(*(synthetic.raycast(world, p, lidar, noise=0.01,
                                            rng=rng, ranges=r)
                          for p, r in zip(poses, ranges)))
    took = time.perf_counter() - t0
    pts0, valid0 = synthetic.raycast(world, poses[0], lidar, noise=0.01,
                                     rng=np.random.default_rng(12))
    check(np.array_equal(pts0, scans[0]) and np.array_equal(valid0, valids[0]),
          "ordered scan 0 from the worker processes differs from the serial "
          "one")
    print(f"data: the bench's ordered figure-8 (240 scans, seed 11, beam "
          f"order), its first {ORDERED_SCANS}, host generation {took:.2f} s "
          f"in {workers} processes [{card}]", flush=True)
    return np.stack(scans), np.stack(valids), poses.astype(np.float32)


def run_ordered_path(pts, msk, gt, card):
    """The bench's ordered path: ``synthetic_config()`` (reshape projection
    of beam-ordered scans, no de-skew, loop closure on) over the ordered
    drive through ``tools.bench.run_engine`` (the bench's 16 warm-up
    scans).  Gates: ATE, k=5 launches (6 a mapping tick), no host sync
    outside the three graph captures (loop ticks included).  Returns the
    kNN launches."""
    cfg = synthetic_config()
    check(cfg.lidar.ordered and not cfg.odom.deskew and cfg.loop.enabled,
          "synthetic_config changed")
    reset_counts()
    with warnings.catch_warnings(record=True) as caught, \
            CaptureWatch() as captures:
        rec = captures.rec = caught
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine, fps = bench.run_engine(cfg, pts, msk, bench.WARMUP,
                                           device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = launch_counts()
    syncs = sync_warnings(rec)
    in_capture = [w for w in syncs if id(w) in captures.ids]
    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    expected = expected_k5(cfg, engine.map_ticks)
    stages = engine.trace.summary(skip_first=bench.WARMUP)
    print(f"ordered path (synthetic_config: beam order, reshape projection, "
          f"no de-skew, loop closure on; tools.bench.run_engine): scans="
          f"{len(pts)} warmup={bench.WARMUP} scans_per_s={fps:.3f} "
          f"ms_per_scan={1e3 / fps:.3f} keyframes={int(engine.m.kf.count)} "
          f"mapping_ticks={engine.map_ticks} loop_ticks={engine.loop_ticks} "
          f"knn_launches_k5={launches[5]} (expected {expected}) "
          f"knn_launches_k1={launches[1]} loops_closed="
          f"{int(engine.loops_closed)} ate_m={ate:.4f} host_syncs: "
          f"graph_captures={len(in_capture)} elsewhere (loop ticks "
          f"included)={len(syncs) - len(in_capture)} (all scans) "
          f"[{card}]", flush=True)
    print("ordered path stages, host ms to launch (mean): " + " ".join(
        f"{name}={1e3 * st['mean']:.2f} (n={st['n']})"
        for name, st in sorted(stages.items())) + f" [{card}]", flush=True)
    print_syncs("ordered path, graph captures", in_capture)
    print_syncs("ordered path, elsewhere",
                [w for w in syncs if id(w) not in captures.ids])
    check(est.shape == (len(pts), 4, 4) and bool(np.isfinite(est).all()),
          "ordered path: trajectory is not finite")
    check(ate < ATE_BAR, f"ordered path: ATE {ate} >= {ATE_BAR} m")
    check(launches[5] > 0 and launches[5] == expected,
          f"ordered path: k=5 launches {launches[5]}, expected {expected}")
    stray = stray_syncs(syncs, captures.ids)
    check(not stray, "ordered path: a sync outside the graph captures: "
          + ", ".join(sorted({where(w) for w in stray})))
    check(captures.captures == 3, f"ordered path: {captures.captures} graph "
          "captures, expected 3")
    check(launches["symeig"] > 0, "ordered path: symeig never launched")
    check_graphs("ordered path", engine, card)
    return launches


def run_latency(cfg, pts, msk, card):
    """``tools.bench``'s latency measure (a synchronize after every scan)
    over the loop drive's first LOOP_WARMUP + LATENCY_SCANS scans."""
    n = LOOP_WARMUP + LATENCY_SCANS
    reset_counts()
    lat = bench.latency_ms(cfg, pts[:n], msk[:n], LOOP_WARMUP, device="cuda")
    launches = launch_counts()
    print(f"latency (tools.bench.latency_ms, default_config, a synchronize "
          f"after every scan, loop ticks included): {lat} "
          f"knn_launches={launches} [{card}]", flush=True)
    check(lat is not None and lat["scans"] == LATENCY_SCANS
          and all(np.isfinite(lat[k]) and lat[k] > 0
                  for k in ("p50", "p95", "p99", "max")),
          f"latency: {lat}")
    return launches


def run_capacity_card(engine, scans, valids, card):
    """``tools.run_capacity`` on the card: part 1 at the tool's settings
    with CAPACITY_EXTRA scans past the cap, part 2 on a second full-size
    state filled from the loop path's keyframes (``engine``, its drive
    ``scans``), the loop bank past its slots.  Every check of the tool is a
    gate; the second state is freed on return."""
    reset_counts()
    try:
        run_capacity.part1("cuda", card, extra=CAPACITY_EXTRA)
        run_capacity.part2("cuda", card, engine, scans, valids,
                           cfg=engine.config)
    except RuntimeError as err:
        check(False, str(err))
    torch.cuda.empty_cache()
    return launch_counts()


# The diagnostics phase: each tool's functions at a reduced depth on the
# drives above (rays are cast here for the tiny configuration only).
DIAG_ODO_GRID = [(8, 2), (2, 2), (1, 1)]
DIAG_MAP_GRID = [(8, 3), (2, 2), (1, 1)]
DIAG_CALLS = 4        # scans (calls) a timing pass: the tools' 8
# An engine with loop closure on spends ~8 s warming up and capturing its
# loop graph: tune_research runs one variant (base is the ordered path's
# configuration), diag_real the two without loop closure.
DIAG_VARIANTS = ("both_re",)
DIAG_REAL_VARIANTS = ("odo", "odo-nodeskew")
DIAG_DRIVE_SCANS = 32    # tune_research, diag_real: 16 warm-up + 16
DIAG_ENGINE2_SCANS = 24  # profile_engine2: 8 warm-up (every capture) + 16
DIAG_ENGINE2_WARM = 8
DIAG_FIG8_FRAMES = 6     # debug_fig8: the first frames of its 60-scan drive
DIAG_TINY_SCANS = 40     # diag_tiny: the first half of its 80-scan drive
DIAG_MICRO_REPS = 5
DIAG_LATENCY_REPS = 2    # profile_latency: 2 x 2 + 2 eager calls a stage


def run_diagnostics(cfg, pts, msk, gt, engine, lidar, o_scans, o_valids,
                    o_gt, card, dev="cuda"):
    """The 11 diagnostics of ``sc_lego_loam_tpu_torch/tools/`` on the card,
    through their functions, at a reduced depth: the profilers on the
    ordered drive's first scans (``synthetic_config()``, the tools' own
    configuration) and on the loop path's end state (``engine``), the
    drives on the loop drive and the ordered drive, the tiny configuration
    on its own small casts.  No profiler session is opened (``profile=
    False``: launches print n/a).  Gates: every CUDA-event time finite and
    > 0; one k=5 kNN call a call of each kNN part of ``profile_s2m`` (and
    of each geometry part); ``scan_to_map`` at (it, re) making two k=5
    calls a research; ``diag_loops`` over the loop path's drive closing the
    loop path's loops (the same factors), every accepted factor true, and
    its trajectory bit-equal to the loop path's.  Returns the phase's kNN
    and symeig launches."""
    t0 = time.perf_counter()
    reset_counts()
    scfg = synthetic_config()
    ocpu = (o_scans[:DIAG_CALLS], o_valids[:DIAG_CALLS])
    device_ms = []

    def timed(rows, label):
        device_ms.extend((label, r["name"], r["device_ms"]) for r in rows)

    odo_rows, map_rows = profile_iters.run(
        scfg, *ocpu, dev, card, odo_grid=DIAG_ODO_GRID,
        map_grid=DIAG_MAP_GRID, reps=1, profile=False, engine=engine)
    timed(odo_rows + map_rows, "profile_iters")
    _, _, rows = profile_odo.run(scfg, *ocpu, dev, card, grid=[(8, 4)],
                                 reps=1, profile=False)
    timed(rows, "profile_odo")
    sizes, parts, s2m_map, s2m_odo = profile_s2m.run(
        scfg, *ocpu, dev, card, map_grid=[(8, 3)], odo_grid=[(1, 1)],
        n=DIAG_CALLS, reps=1, profile=False, engine=engine)
    timed(parts + s2m_map + s2m_odo, "profile_s2m")
    for r in parts:
        check(r["knn_k5"] == 1, f"profile_s2m {r['name']}: "
              f"{r['knn_k5']} k=5 calls a call, expected 1")
    for r in map_rows + s2m_map:
        want = 2 * profile_iters.researches(r["it"], r["re"])
        check(r["knn_k5"] == want, f"{r['name']}: {r['knn_k5']} k=5 calls a "
              f"call, expected {want} (two a research)")
    n = DIAG_DRIVE_SCANS
    tune_research.run(
        DIAG_VARIANTS, [11], dev, card, n_scans=n, warm=bench.WARMUP,
        sequence=lambda seed: (o_scans[:n], o_valids[:n], o_gt[:n]))
    print(f"diagnostics: diag_loops over the loop path's drive "
          f"({len(gt)} scans, {cfg.lidar.name}) [{card}]", flush=True)
    res = diag_loops.replay(cfg, pts, msk, gt, dev, label="loop drive")
    diag, mine = res["engine"], engine
    same_loops = int(diag.loops_closed) == int(mine.loops_closed) and all(
        torch.equal(getattr(diag.m.loops, f), getattr(mine.m.loops, f))
        for f in ("i", "j", "count"))
    bad = [f for f in res["factors"] if f[3] >= FACTOR_TOL_M]
    print(f"diagnostics: diag_loops loop_ticks={len(res['records'])} "
          f"candidates_verified="
          f"{sum(r['sc'] is not None or r['rs'] is not None for r in res['records'])} "
          f"loops_closed={int(diag.loops_closed)} (loop path "
          f"{int(mine.loops_closed)}) factors={len(res['factors'])} "
          f"false={len(bad)} trajectory_bit_equal="
          f"{np.array_equal(res['est'], lidar['est'])} [{card}]", flush=True)
    check(same_loops, "diag_loops: not the loop path's loops")
    check(res["factors"] and not bad,
          f"diag_loops: accepted factors not all true: {res['factors']}")
    check(np.array_equal(res["est"], lidar["est"]),
          "diag_loops: the trajectory differs from the loop path's")
    check(len(res["records"]) == diag.loop_ticks,
          "diag_loops: a loop tick without its record")
    del res, diag
    free_memory()
    for variant in DIAG_REAL_VARIANTS:
        diag_real.diagnose(variant, diag_real.variant_config(variant),
                           pts[:n], msk[:n], gt[:n], dev, card)
    n2 = DIAG_ENGINE2_SCANS
    profile_engine2.run(scfg, o_scans[:n2], o_valids[:n2], dev, card,
                        warm=DIAG_ENGINE2_WARM)
    tiny = debug_fig8.make_scans(tiny_test_config())
    debug_fig8.run(tiny_test_config(),
                   *(x[:DIAG_FIG8_FRAMES] for x in tiny), dev, card)
    tcfg = diag_tiny.config()
    diag_tiny.run(tcfg, *(x[:DIAG_TINY_SCANS]
                          for x in diag_tiny.make_scans(tcfg)), dev, card)
    micro, same = profile_micro.run(scfg, o_scans[1], o_valids[1], dev, card,
                                    reps=DIAG_MICRO_REPS)
    check(same, "profile_micro: the two descriptors differ")
    device_ms.extend(("profile_micro", r["name"], r["device_ms"])
                     for r in micro)
    latency = profile_latency.run(
        cfg, pts[:profile_latency.N], msk[:profile_latency.N], dev, card,
        engine=engine, reps=DIAG_LATENCY_REPS, profile=False)
    timed(latency, "profile_latency")
    bad = [x for x in device_ms
           if x[2] is None or not np.isfinite(x[2]) or x[2] <= 0]
    check(not bad, f"diagnostics: device times not finite and > 0: {bad}")
    launches = launch_counts()
    took = time.perf_counter() - t0
    print(f"diagnostics phase: {len(device_ms)} device times, kNN launches "
          f"k=5 {launches[5]} k=1 {launches[1]} symeig "
          f"{launches['symeig']}, {took:.1f} s [{card}]", flush=True)
    return launches


def stack_frames(log) -> dict:
    """Bytes of stack frame (local memory) per function in ptxas's
    report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def check_no_jax():
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "sc_lego_loam_tpu")
                 or m.startswith(("jax.", "sc_lego_loam_tpu.")))
    check(not bad, f"imported: {bad}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--drive", choices=sorted(DRIVES), default="figure8")
    args = parser.parse_args()
    drive = args.drive
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = bench.card_line("cuda")
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    print(f"card: {card}", flush=True)

    scans, valids, gt = make_drive(default_config(), drive, card)
    # The batch drive's and the ordered drive's rays are cast in worker
    # processes while this one builds the kernel and checks it on the card
    # (device-timed).
    pool = concurrent.futures.ThreadPoolExecutor(1)
    b_drive = pool.submit(make_batch_drive, default_config(), card)
    o_drive = pool.submit(make_ordered_drive, synthetic_config().lidar, card)

    info = cuda_knn.build()
    print(f"build: {info.path} in {info.seconds:.2f} s [{card}]", flush=True)
    kernels_built = ptxas_lines(info.log)
    for name, regs, stores, loads in kernels_built:
        print(f"  ptxas: {name}: {regs} registers, spill stores {stores} "
              f"bytes, spill loads {loads} bytes", flush=True)
        check(stores == 0 and loads == 0, f"{name} spills registers")
    check(bool(kernels_built) or info.seconds == 0.0,
          "nvcc printed no ptxas report")
    # A register array indexed at run time would sit in local memory (a
    # stack frame): the symeig schedule must be unrolled to constants.
    frames = stack_frames(info.log)
    for name, nbytes in frames.items():
        if "symeig" in name:
            print(f"  ptxas: {name}: {nbytes} bytes stack frame", flush=True)
            check(nbytes == 0, f"{name} keeps a stack frame")
    check(any("symeig_kernel" in name for name in frames)
          or info.seconds == 0.0, "no ptxas report of the symeig kernels")
    # ~50 % valid targets and 90 % live queries, uniform in a 40x40x4 m box.
    results = [kernel_vs_plain(name, k, *uniform_cloud(seed, Q, T), max_sq,
                               card)
               for seed, (name, k, Q, T, max_sq) in enumerate(SHAPES)]
    vlp16 = [kernel_vs_plain(name, k, *uniform_cloud(seed, Q, T), max_sq,
                             card)
             for seed, (name, k, Q, T, max_sq) in enumerate(VLP16_SHAPES, 3)]
    tie_and_small_count_checks(card)
    batched_kernel_checks(card)
    sym_row = symeig_checks(scans, valids, gt, card)
    small_linalg_times(card)
    prepare_targets_times(card)
    set_condition_times(card)
    probe_times(card)
    b_scans, b_valids, b_gt = b_drive.result()
    o_scans, o_valids, o_gt = o_drive.result()
    pool.shutdown()

    def elapsed(after):
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s after {after}",
              flush=True)

    pts = torch.from_numpy(scans).cuda()
    msk = torch.from_numpy(valids).cuda()
    base = default_config()
    check(base.loop.enabled and not base.imu.enabled
          and base.odom.joint_6dof, "default_config changed")
    paths = {}         # path -> kNN launches, counted from 0 for each
    paths["slice"], joint_syncs = run_slice(
        loop_off(base), "slice (loop closure off)", pts, msk, gt, card)
    two_stage = loop_off(base).replace(odom=dataclasses.replace(
        base.odom, joint_6dof=False, dense_queries=False))
    paths["two-stage"], stage_syncs = run_slice(
        two_stage, "two-stage slice (joint_6dof=False, sparse picks, loop "
        "closure off)", pts, msk, gt, card)
    print(f"two-stage odometry: host syncs in the slice's timed window "
          f"{stage_syncs} against the joint solver's {joint_syncs} (both "
          f"0: the 3x3 and 6x6 eigendecompositions are the symeig kernel) "
          f"[{card}]", flush=True)
    elapsed("the slices")

    paths["loop"], engine, lidar = run_loop_path(
        base, "loop path (default_config, loop closure on)", pts, msk, gt,
        card)
    elapsed("the loop path")
    run_closing_tick(base, engine, lidar, card)
    elapsed("the closing tick")
    probe_checks(base, engine, pts, msk, card)
    elapsed("the probe records")
    paths["closing-window latency"] = run_closing_latency(base, pts, msk,
                                                          card)
    elapsed("the closing-window latency")
    plain_first = run_repeatable(base, pts, msk, engine, card)
    elapsed("repeatable")
    b_pts = torch.from_numpy(b_scans).cuda()
    b_msk = torch.from_numpy(b_valids).cuda()
    for S, (n, _) in run_batch_sizes(base, b_pts, b_msk, b_gt, lidar,
                                     card).items():
        paths[f"batch S={S}"] = n
    elapsed("the batch at S > 3")
    imu_cfg = base.replace(imu=ImuConfig(enabled=True))
    imu_pts, imu_msk = pts[:IMU_SCANS], msk[:IMU_SCANS]
    paths["imu"], imu_engine, with_imu = run_loop_path(
        imu_cfg, f"IMU path (imu.enabled, loop closure on, the first "
        f"{IMU_SCANS} scans)", imu_pts, imu_msk, gt[:IMU_SCANS], card,
        with_imu=True, revisits=False)
    print(f"IMU path ({IMU_SCANS} scans) beside the lidar-only loop path "
          f"(240): ate_m "
          f"{with_imu['ate']:.4f} / {lidar['ate']:.4f} ate_as_published_m "
          f"{with_imu['ate_raw']:.4f} / {lidar['ate_raw']:.4f} scans_per_s "
          f"{with_imu['scans_per_s']:.3f} / {lidar['scans_per_s']:.3f} "
          f"host_syncs_outside_loop_ticks {with_imu['syncs_elsewhere']} / "
          f"{lidar['syncs_elsewhere']} peak_mem_bytes_of_the_path "
          f"{with_imu['peak']} / "
          f"{lidar['peak']} [{card}]", flush=True)
    elapsed("the IMU path")

    paths["batch"], batch_engine, batched = run_batch_path(
        base, b_pts, b_msk, b_gt, lidar, card)
    elapsed("the batch path")
    run_merge(base, batch_engine, b_gt, card)
    elapsed("the merge")

    # M1, then the eager S=3 batch, run in this process while M2's two
    # processes drive (the host would wait on them otherwise); each reads
    # its own kNN counts (M2's ranks in their processes).
    def behind_m2():
        m1 = run_mesh1(base, pts, msk, engine, plain_first, card)
        launches, eager_batch, summary = run_batch_path(
            base, b_pts, b_msk, b_gt, lidar, card, eager=True,
            beside="while M2's two processes drive")
        del eager_batch
        free_memory()
        return m1, launches, summary

    m2, (paths["mesh M1"], paths["batch S=3 eager"], eager_batched) = \
        run_mesh2(scans, valids, gt, engine, lidar, card,
                  background=behind_m2)
    for r, n in enumerate(m2):
        paths[f"mesh M2 rank {r}"] = n
    compare_batches(batched, eager_batched, card)
    elapsed("mesh M1, the eager batch and M2")
    for r, n in enumerate(run_mesh3(b_scans, b_valids, b_gt, card)):
        paths[f"mesh M3 rank {r}"] = n
    elapsed("mesh M3")

    paths["runner"] = run_runner(scans, valids, gt, card)
    elapsed("the runner")
    paths["ordered"] = run_ordered_path(torch.from_numpy(o_scans).cuda(),
                                        torch.from_numpy(o_valids).cuda(),
                                        o_gt, card)
    elapsed("the ordered path")
    paths["latency"] = run_latency(base, pts, msk, card)
    elapsed("latency")
    paths["capacity"] = run_capacity_card(engine, scans, valids, card)
    elapsed("the capacity runway")
    paths["diagnostics"] = run_diagnostics(
        base, pts, msk, gt, engine, lidar, o_scans, o_valids, o_gt, card)
    elapsed("the diagnostics")
    # From here on nothing counts as a launch of a path.
    checkpoint_resume(engine, pts, msk, card)
    elapsed("the checkpoint")
    imu_parts(imu_engine, imu_pts, imu_msk, card)
    del imu_engine
    clouds = loop_tick_breakdown(engine, card)
    real_cloud_checks(engine, clouds, card)
    batch_step_launches(batch_engine, engine, b_pts, b_msk, card)
    elapsed("the breakdowns")
    rows = profile_stages.profile_engine(engine, scans[-1], valids[-1],
                                         len(scans) * 0.1, card, PROFILE_REPS)
    replays = [r for r in rows if "replay" in r["name"]]
    # perception, mapping, the loop tick by three outcomes, the batch's
    # three steps.
    check(len(replays) == 8 and all(r["device_ms"] > 0 and r["syncs"] == 0
                                    for r in replays),
          "profile_stages: the graph replay rows")
    outcomes = {r["name"].split(",")[0] for r in replays
                if r["name"].startswith("loop_step")}
    check(outcomes == {"loop_step no candidate", "loop_step verified",
                       "loop_step closed"},
          f"profile_stages: loop tick outcomes {sorted(outcomes)}")
    check(all(r["launches"] > 0 for r in rows if r not in replays),
          "profile_stages: a sub-stage launched no kernel")
    elapsed("profile_stages")
    check_no_jax()
    elapsed("everything")

    surf, corner, icp = results
    common = dict(route="cuda", source=KNN_SOURCE, replaces=KNN_REPLACES)
    per_path = {k: {name: n[k] for name, n in paths.items()}
                for k in (5, 1, "symeig")}
    print(f"kNN launches by path: k=5 {per_path[5]} k=1 {per_path[1]} "
          f"[{card}]", flush=True)
    print(f"symeig launches by path: {per_path['symeig']} [{card}]",
          flush=True)
    k5 = dict(name="knn_topk_k5", **common,
              launches=sum(per_path[5].values()), **surf)
    k5["max_abs_err"] = max(surf["max_abs_err"], corner["max_abs_err"],
                            vlp16[0]["max_abs_err"], vlp16[1]["max_abs_err"])
    k1 = dict(name="knn_topk_k1", **common,
              launches=sum(per_path[1].values()), **icp)
    k1["max_abs_err"] = max(icp["max_abs_err"], vlp16[2]["max_abs_err"])
    check(all(n > 0 for n in per_path[5].values()),
          f"a path never launched the k=5 kernel: {per_path[5]}")
    check(per_path[1]["loop"] > 0 and per_path[1]["batch"] > 0
          and per_path[1]["mesh M2 rank 0"] > 0
          and per_path[1]["mesh M2 rank 1"] > 0,
          f"a loop-closing path never launched the k=1 kernel: {per_path[1]}")
    check(all(n > 0 for n in per_path["symeig"].values()),
          f"a path never launched the symeig kernel: {per_path['symeig']}")
    sym = dict(name="symeig", route="cuda", source=SYMEIG_SOURCE,
               replaces=SYMEIG_REPLACES,
               launches=sum(per_path["symeig"].values()), **sym_row)
    print(f"card: {card}")
    print(json.dumps({"kernels": [k5, k1, sym]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
