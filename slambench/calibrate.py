"""Readings behind the limits of ``correct``: runs a cell at its own size on
many seeds, sound, as the control (TF32 on) and with planted faults
(``faults.py``), and prints each run's compared numbers.

    python3 slambench/calibrate.py --workload NAME --seconds S \\
        --seeds 1,2,3 [--control 4,5,6] [--fault unchanged:7,8] \\
        [--per-process K] [--out FILE.jsonl]

A fault's name may join several with ``+``, planted together.  Runs
share a process, K at a time (``--per-process``; a fleet's engines
leave memory behind in their CUDA graphs' pools).  The benchmark's own
runs never call this.  ``altered`` moves the pose of the cell's warm-up
plus 5th scan.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


class _Tee:
    """Standard error that keeps the run's ``slambench: accuracy`` line."""

    def __init__(self):
        self.accuracy = None

    def write(self, text):
        if text.startswith("slambench: accuracy "):
            self.accuracy = json.loads(text[len("slambench: accuracy "):])
        return sys.stderr.write(text)

    def flush(self):
        sys.stderr.flush()


def run_jobs(workload: str, seconds: float, jobs: list, out: str | None):
    sys.path.insert(0, ROOT)
    from slambench import faults, plan, run as bench
    bench.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        bench.fail("no CUDA device")
    torch.set_num_threads(4)
    cell = plan.load_cell(workload, os.path.join(ROOT, "BENCHMARK.json"))
    at = int(cell.config["warmup_scans"]) + 5
    for kind, seed in jobs:
        t = time.time()
        log = _Tee()
        if kind not in ("sound", "control"):
            with contextlib.ExitStack() as stack:
                for name in kind.split("+"):
                    stack.enter_context(faults.FAULTS[name](at))
                r = bench.run_cell(cell, seed, seconds, False, "cuda",
                                   log=log)
        else:
            r = bench.run_cell(cell, seed, seconds, False, "cuda",
                               tf32=(kind == "control"), log=log)
        line = {"workload": cell.name, "kind": kind, "seed": seed,
                "correct": r["correct"],
                "numbers": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "attempted": r["attempted"],
                "accuracy": log.accuracy,
                "peak": r["device"]["memory_peak_bytes"],
                "wall_s": time.time() - t}
        print("calibrate " + json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="NAME:SEED,SEED")
    ap.add_argument("--job", action="append", default=[],
                    help="KIND:SEED (sound, control or a fault)")
    ap.add_argument("--per-process", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    jobs = [("sound", s) for s in _seeds(args.seeds)]
    jobs += [("control", s) for s in _seeds(args.control)]
    for f in args.fault:
        name, seeds = f.split(":")
        jobs += [(name, s) for s in _seeds(seeds)]
    for j in args.job:
        kind, seed = j.split(":")
        jobs.append((kind, int(seed)))
    k = args.per_process
    if not k or len(jobs) <= k:
        run_jobs(args.workload, args.seconds, jobs, args.out)
        return 0
    for a in range(0, len(jobs), k):
        cmd = [sys.executable, os.path.abspath(__file__), "--workload",
               args.workload, "--seconds", str(args.seconds)]
        for kind, seed in jobs[a:a + k]:
            cmd += ["--job", f"{kind}:{seed}"]
        if args.out:
            cmd += ["--out", args.out]
        rc = subprocess.run(cmd).returncode
        if rc:
            print(f"calibrate: jobs {a}..{a + k - 1} exited {rc}",
                  file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
