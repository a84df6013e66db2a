"""Multi-process dry run of the mesh paths (the port's counterpart of
``__graft_entry__.dryrun_multichip``), and the launcher it runs them with.

    python -m sc_lego_loam_tpu_torch.tools.dryrun_multichip --n 4 [--device cpu]

Starts ``n`` processes that join one ``torch.distributed`` group (gloo,
through a ``FileStore`` in a fresh directory) and a ``(seq, kf)`` mesh:
``(2, n/2)`` for n >= 4, ``(1, n)`` otherwise.  Each drives the four mesh
paths on ``tiny_test_config()``:

1. ``SlamEngine(cfg, mesh=mesh)`` over the 12-scan straight drive, banks
   sharded over 'kf', held against an unsharded engine that this process
   drives meanwhile: keyframe count within 2, ATE below
   max(2 x the unsharded ATE, the unsharded ATE + 0.15 m);
2. ``parallel.retrieval.detect_sharded`` on the engine's own bank;
3. ``posegraph.solve(..., mesh=mesh)`` on the engine's keyframe graph with
   one loop factor;
4. ``parallel.batch.merge_solve`` over two copies of the chain joined by
   one cross-sequence factor.

It prints one ``ok`` line, or fails: a rank that raises, exits non-zero or
outlives the time limit fails the run.  Every rank runs on card 0 (gloo
runs ``all_reduce`` / ``broadcast`` on CUDA tensors, so several processes
share one card); without a card that is an error.  ``--device cpu`` runs
the ranks on the CPU instead.

``run_ranks`` is the launcher: it starts the processes with
``python -m sc_lego_loam_tpu_torch.tools.dryrun_multichip --rank ...``,
which join the group, call the target ``module:function`` with the given
keyword arguments, and leave.  The tests and ``chip_smoke.py`` start
their rank functions with it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
N_SCANS = 12


def mesh_shape(n: int) -> tuple[int, int]:
    """(n_seq, n_kf) of an n-process dry run, as the JAX package's."""
    return (2, n // 2) if n >= 4 else (1, n)


def run_ranks(world: int, target: str, kwargs: dict, *, device: str = "cuda",
              timeout: float = 900.0, path=(), background=None):
    """Run ``target`` ("module:function") in ``world`` processes of one
    gloo group, each called as ``function(mesh_info, **kwargs)``; see
    ``_rank_main``.  ``path`` is prepended to each process's ``PYTHONPATH``.
    ``background`` (optional) runs in this process while the ranks do.
    Raises unless every rank exits with 0 inside ``timeout`` seconds; the
    processes are stopped either way.  Returns what ``background``
    returned."""
    workdir = tempfile.mkdtemp(prefix="mesh_store_")
    store = os.path.join(workdir, "store")
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [*path, REPO] + [p for p in [child_env.get("PYTHONPATH")] if p])
    procs = []
    logs = []
    try:
        for r in range(world):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "sc_lego_loam_tpu_torch.tools.dryrun_multichip",
                 "--rank", str(r), "--world", str(world), "--store", store,
                 "--device", device, "--target", target,
                 "--kwargs", json.dumps(kwargs)],
                stdout=log, stderr=subprocess.STDOUT, env=child_env,
                cwd=REPO))
        out = background() if background is not None else None
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        codes = [p.poll() for p in procs]
        if codes != [0] * world:
            tails = []
            for r, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {r} (exit {codes[r]}) ---\n"
                             + "".join(log.readlines()[-40:]))
            raise RuntimeError(
                f"{target} on {world} ranks failed: exit codes {codes}\n"
                + "\n".join(tails))
        for log in logs:
            log.seek(0)
            sys.stdout.write(log.read())
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def _rank_main(args):
    """One rank: join the group (gloo, ``FileStore``), call the target."""
    import torch.distributed as dist
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device")
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(args.store, args.world),
        rank=args.rank, world_size=args.world)
    try:
        module, fn = args.target.split(":")
        getattr(importlib.import_module(module), fn)(
            dict(rank=args.rank, world=args.world, device=args.device),
            **json.loads(args.kwargs))
    finally:
        dist.destroy_process_group()


def dryrun_rank(info, out: str):
    """The four mesh paths on one rank; rank 0 writes what the parent
    checks to ``out`` (an NPZ)."""
    from .. import posegraph
    from ..config import tiny_test_config
    from ..parallel import batch, mesh as mesh_mod, retrieval
    from ..pipeline import SlamEngine
    from ..utils import se3

    cfg = tiny_test_config()
    dev = info["device"]
    n_seq, n_kf = mesh_shape(info["world"])
    mesh = mesh_mod.make_mesh(n_kf, n_seq, device_type=dev)
    K = cfg.cap.max_keyframes
    assert K % n_kf == 0 and cfg.posegraph.max_loops % n_kf == 0

    scans, valids, _ = _drive(cfg)
    engine = SlamEngine(cfg, device=dev, mesh=mesh)
    for i in range(N_SCANS):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    traj = engine.trajectory_array()

    # (2) Sharded Scan Context retrieval over the engine's own bank.
    bank = engine.bank
    query = mesh_mod.gather_rows(
        bank.desc, torch.zeros(1, dtype=torch.int64, device=dev), mesh)[0]
    idx, dist, _ = retrieval.detect_sharded(cfg, mesh, bank.desc, bank.count,
                                            query)

    # (3) The sharded solve of the engine's keyframe graph, one loop factor
    # from the newest keyframe to the first at their current poses.
    kf = engine.map.kf
    n = int(kf.count)
    X = se3.pose6_to_mat(kf.poses6)
    loops = posegraph.add_loop(
        posegraph.init_loops(cfg, dev), n - 1, 0,
        se3.mat_inv(X[n - 1]) @ X[0])
    solved = posegraph.solve(cfg, kf.poses6, kf.count, kf.odom_z, loops,
                             mesh=mesh)

    # (4) Two copies of the chain with one cross-sequence factor.
    poses2 = torch.stack([kf.poses6, kf.poses6])
    odom2 = torch.stack([kf.odom_z, kf.odom_z])
    counts = torch.stack([kf.count, kf.count])
    xloops = posegraph.add_loop(
        posegraph.init_loops(cfg, dev), K, 0,
        torch.eye(4, device=dev))
    merged = batch.merge_solve(cfg, poses2, counts, odom2, xloops)

    if info["rank"] == 0:
        np.savez(out, traj=traj, kf_count=n, idx=int(idx), dist=float(dist),
                 solved=solved.cpu().numpy(), merged=merged.cpu().numpy(),
                 mesh=np.array([n_seq, n_kf]))


def _drive(cfg):
    from ..utils import synthetic
    return synthetic.make_sequence(cfg.lidar, N_SCANS, trajectory="straight",
                                   step=0.4, noise=0.01, seed=1)


def dryrun(n: int, device: str = "cuda") -> str:
    """Run the dry run over ``n`` processes; returns the ``ok`` line."""
    from ..config import tiny_test_config
    from ..pipeline import SlamEngine
    from ..utils import evaluate

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device")
    cfg = tiny_test_config()
    scans, valids, gt = _drive(cfg)

    def reference():
        if device == "cpu":
            torch.set_num_threads(1)
        eng = SlamEngine(cfg, device=device)
        for i in range(N_SCANS):
            eng.process_scan(scans[i], valids[i], t=i * 0.1)
        return eng.trajectory_array(), int(eng.m.kf.count)

    out = os.path.join(tempfile.mkdtemp(prefix="dryrun_"), "rank0.npz")
    t_ref, kf_ref = run_ranks(
        n, "sc_lego_loam_tpu_torch.tools.dryrun_multichip:dryrun_rank",
        dict(out=out), device=device, background=reference)
    with np.load(out) as z:
        r = {k: z[k] for k in z.files}
    traj = r["traj"]
    assert np.isfinite(traj).all(), "sharded trajectory is not finite"
    kf = int(r["kf_count"])
    assert kf >= 1 and abs(kf - kf_ref) <= 2, \
        f"sharded run lost keyframes: {kf} against {kf_ref}"
    ate_ref = evaluate.ate_rmse(t_ref, gt)
    ate_sh = evaluate.ate_rmse(traj, gt)
    assert ate_sh < max(2.0 * ate_ref, ate_ref + 0.15), (
        f"sharded engine lost tracking: ATE {ate_sh:.3f} against the "
        f"unsharded {ate_ref:.3f}")
    assert np.isfinite(r["dist"]) and int(r["idx"]) >= -1
    assert np.isfinite(r["solved"]).all() and np.isfinite(r["merged"]).all()
    n_seq, n_kf = (int(x) for x in r["mesh"])
    return (f"dryrun_multichip({n}): ok — mesh=({n_seq}x{n_kf}), engine "
            f"kf={kf} (unsharded {kf_ref}), ATE {ate_sh:.3f} m (unsharded "
            f"{ate_ref:.3f}), retrieval dist={float(r['dist']):.3f}, "
            f"posegraph+merge finite")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="processes")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    # A rank started by run_ranks:
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--store")
    p.add_argument("--target")
    p.add_argument("--kwargs", default="{}")
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    print(dryrun(args.n, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
