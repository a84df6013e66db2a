"""The LM iterations the convergence deltas keep (a script, not a test):
an eager engine over the bench's figure-8 records, for every odometry LM
(``odometry._lm_loop``) and every ``mapping.scan_to_map``, the first
iteration whose convergence flag was already set, read from the
``done`` each iteration's probe (``graphs.probe``) carries.  The JAX
package stops there (its iterations are gated with ``lax.cond``), and so
does the port's odometry LM (``graphs.cond``); ``scan_to_map`` runs on
and keeps the converged state with ``solver.freeze``, so its iterations
after it, and the researches among them, are paid for nothing.
``tools/profile_iters``' fit prices them.

    PYTHONPATH=. python tests/torch_lm_probe.py [scans] [real|ordered]
        [--device cuda]

``real``: ``runner.mulran_engine_config()`` on the skewed figure-8 (the
bench's headline drive); ``ordered``: ``synthetic_config()`` on the
beam-ordered one.  Prints, per LM, the iterations needed (mean, median,
p10, p90, min, max, how many ran to the cap, a histogram) and the
iterations and researches left after convergence, per call.  The flags
are read on the host, so the engine runs eagerly.
"""

import argparse
import collections

import numpy as np

from sc_lego_loam_tpu_torch import mapping, odometry
from sc_lego_loam_tpu_torch.config import synthetic_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.runner import mulran_engine_config
from sc_lego_loam_tpu_torch.tools import bench, profile_iters


class RecordingGraphs:
    """``graphs`` with ``probe`` appending the flag its LM iteration site
    reports to ``flags`` (one record an iteration)."""

    def __init__(self, graphs, site):
        self._graphs = graphs
        self._site = site
        self.flags = None

    def __getattr__(self, name):
        return getattr(self._graphs, name)

    def probe(self, site, value=None):
        if self.flags is not None and site == self._site:
            self.flags.append(bool(value))
        return self._graphs.probe(site, value)


def record(module, name, graphs, out, cap):
    """Wrap ``module.name`` so that each call appends to ``out`` the
    iterations its LM needed (the first iteration entered converged, or
    ``cap``) and ``cap``."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        graphs.flags = []
        try:
            return fn(*args, **kwargs)
        finally:
            flags, graphs.flags = graphs.flags, None
            out.append((next((i + 1 for i, d in enumerate(flags) if d), cap),
                        cap))

    setattr(module, name, wrapped)


def summary(label, runs, research_every, skip=0):
    used = np.array([u for u, _ in runs[skip:]])
    cap = runs[0][1]
    left_it = cap - used
    left_re = [profile_iters.researches(cap, research_every)
               - profile_iters.researches(max(int(u), 1), research_every)
               for u in used]
    print(f"{label}: calls={len(used)} cap={cap} iterations needed: "
          f"mean={used.mean():.2f} median={np.median(used):.1f} "
          f"p10={np.percentile(used, 10):.1f} "
          f"p90={np.percentile(used, 90):.1f} min={used.min()} "
          f"max={used.max()} at_cap={int((used == cap).sum())} "
          f"histogram={dict(sorted(collections.Counter(used.tolist()).items()))}"
          f"; left after convergence a call: iterations "
          f"{left_it.mean():.2f}, researches {np.mean(left_re):.2f}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scans", nargs="?", type=int, default=80)
    ap.add_argument("drive", nargs="?", default="real",
                    choices=("real", "ordered"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = bench.require_device(args.device)
    if args.drive == "real":
        cfg = mulran_engine_config()
        scans, valids, _ = bench.real_sequence(cfg, bench.N_SCANS)
    else:
        cfg = synthetic_config()
        scans, valids, _ = bench.get_sequence(
            cfg.lidar, bench.N_SCANS, trajectory="figure8", noise=0.01,
            seed=bench.SEED, shuffle=False, radius=30.0, loops=1.05)
    runs = {"odometry": [], "scan_to_map": []}
    odo_graphs = RecordingGraphs(odometry.graphs, "perception.lm_iter")
    map_graphs = RecordingGraphs(mapping.graphs, "mapping.lm_iter")
    odometry.graphs, mapping.graphs = odo_graphs, map_graphs
    record(odometry, "_lm_loop", odo_graphs, runs["odometry"],
           cfg.odom.max_iterations)
    record(mapping, "scan_to_map", map_graphs, runs["scan_to_map"],
           cfg.mapping.max_iterations)
    engine = SlamEngine(cfg, device=device, eager=True)
    for i in range(args.scans):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    print(f"probe {args.drive}: {args.scans} scans, eager "
          f"[{bench.card_line(device)}]", flush=True)
    # Scan 0 initializes the odometry (no targets: it never converges).
    summary("odometry", runs["odometry"], cfg.odom.research_every, skip=1)
    summary("scan_to_map", runs["scan_to_map"],
            cfg.mapping.research_every)


if __name__ == "__main__":
    main()
