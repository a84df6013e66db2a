"""The benchmark of the PyTorch and CUDA port (``sc_lego_loam_tpu_torch``).

    python3 slambench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` on the card it is started on: makes
the cell's drive on the card from ``--seed`` (``caster.py``), brings the
scans to the host, builds the engine, warms up the cell's shapes, then
measures for ``--seconds`` seconds in the cell's mode (``session.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from
CUDA events, one ``torch.profiler`` stretch and the program's own trace,
each phase over the fixed count of scans its mix names
(``trace_<phase>_scans``), whatever ``--seconds`` says.  After the window
the program's answers are judged against the plain reference
(``judge.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), with the compared numbers and their limits last under
``checks``.  Those numbers are also the last lines of standard error.
The run fails, printing no result, without a CUDA card (or with fewer
than the cell asks for), and if ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded in this process once the window has closed.
"""

import time

_T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "sc_lego_loam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``sc_lego_loam_tpu_torch`` is not ``sc_lego_loam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 1):
    print(f"slambench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cache_dirs(root: str = ROOT):
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc library goes to its own ``_build/`` there)."""
    base = os.path.join(root, "slambench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float = None, tf32: bool = False, log=sys.stderr) -> dict:
    """One run of ``cell`` (``plan.Cell``): set-up, window, judgement.
    Returns the result object; ``device`` "cpu" runs the engines eagerly
    (for tests: no trace there)."""
    import numpy as np
    import torch

    from slambench import caster, judge, session

    t0 = time.time() if t0 is None else t0
    cfg, traffic = cell.config, cell.traffic
    streams = int(cfg["streams"])
    lidar = cfg["pipeline"]["lidar"]
    cuda = torch.device(device).type == "cuda"

    phases = {"start": time.time() - t0}
    drive = caster.make_drive(lidar, traffic, seed, int(cfg["drive_scans"]),
                              streams, device, cfg.get("imu_stream"))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phases["drive"] = time.time() - t0
    system = session.System(cfg, device, tf32=tf32)
    phases["engine"] = time.time() - t0
    run = session.Run(system, drive)
    run.warm_up(int(cfg["warmup_scans"]))
    setup_s = time.time() - t0
    phases["warm_up"] = setup_s
    print("slambench: set-up s at the end of each phase "
          + json.dumps(phases), file=log)

    mode, lead = traffic["mode"], int(traffic["lead"])
    metrics, breakdown, rec = {}, None, None
    first = run.next
    if trace:
        rec = session.trace_record(run, traffic, int(cfg["trace_scans"]),
                                   int(cfg["trace_warm_scans"]))
        for m in cell.per_layer:
            v = cell.readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof = rec.get("profile")
        if prof:
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
    elif mode == "replay":
        n, window_s = run.replay(seconds, lead)
        e2e = {"scans_per_s": n * streams / window_s}
    else:
        lat, window_s = run.latency(seconds)
        e2e = {"scan_latency_p95_ms": float(np.percentile(lat, 95))}
        print(f"slambench: latency ms p50 {np.percentile(lat, 50)} "
              f"p95 {np.percentile(lat, 95)} p99 {np.percentile(lat, 99)} "
              f"max {max(lat)} over {len(lat)} scans", file=log)
    if not trace:
        push = [v for i, v in system.push_ms.items() if i >= first]
        if push:
            # The host's share of the window in the IMU pushes.
            print(f"slambench: imu push host ms mean {np.mean(push)} p95 "
                  f"{np.percentile(push, 95)} over {len(push)} pushes, "
                  f"{sum(push) / (window_s * 1e3)} of the window",
                  file=log)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if run.exhausted:
        print(f"slambench: the drive ran out after {run.next} scans; the "
              "window ended with it", file=log)
    session.sync(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    bad = forbidden_modules()
    if bad:
        fail(f"loaded after the window: {', '.join(bad)}")

    published = run.published()
    banks = system.banks()
    map_at = set(run.map_at)
    attempted = (run.next - first) * streams
    del run, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    nums, diag = judge.numbers(cfg, traffic, published, banks, first,
                               map_at)
    correct, rows = judge.verdict(nums, cell.limits)
    print("slambench: accuracy " + json.dumps(diag), file=log)
    for name, v, lim in rows:
        print(f"slambench: check {name} {v} limit {lim}", file=log)
    log.flush()

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and rec.get("profile"):
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["window_s"]
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": metrics,
           "device": dev}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from slambench import plan

    cell = plan.load_cell(args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0=_T0)
    bad = forbidden_modules()
    if bad:
        fail(f"loaded: {', '.join(bad)}")
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
