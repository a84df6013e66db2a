"""The cost of the engine's tracer on the card, on the headline cell's
configuration and drive (``slambench``'s ``mulran-os1-64`` and
``fig8.replay``), one JSON line:

- ``off``: the perception and mapping graphs' replay in device ms (CUDA
  events around 100 and 40 replays, 8 rounds, tracing off) and each
  graph's nodes; on a tree with the tracer, 16 probe nodes alone in a
  graph with the on-flag off and on;
- ``flag``: the perception replay with the probes' on-flag off and on, in
  turns;
- ``on``: scans/s and per-scan latency with tracing off and on, in
  alternate blocks of scans of one process, so that both see the same
  places of the drive.

    python sc_lego_loam_tpu_torch/tools/trace_cost.py ROOT off|flag|on

ROOT is the checkout whose package and ``slambench`` are imported, so that
a parent and a change are measured by one script (run it as a file, not
with ``-m``).
"""

import json
import os
import statistics
import sys

SEED = 2147483901


def _replay_ms(torch, replay, reps: int, rounds: int) -> list:
    """Device ms a replay: CUDA events around ``reps`` replays, per round."""
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return out


def cost_off(torch, engine, dev) -> dict:
    """The graphs' replays with tracing off, and 16 probes alone."""
    res = {"nodes": {g.name: [g.nodes, g.census] for g in engine.graphs}}
    for key, g, reps in (("perception_ms", engine.graphs[0], 100),
                         ("mapping_ms", engine.graphs[1], 40)):
        _replay_ms(torch, g.replay, reps, 1)       # settle the clocks first
        res[key] = _replay_ms(torch, g.replay, reps, 8)
        res[key + "_median"] = statistics.median(res[key])
    if hasattr(engine, "trace"):
        # What the perception graph's 16 probes add to a replay.
        from sc_lego_loam_tpu_torch import graphs
        ring = graphs.ProbeRing(dev)
        g16 = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g16, stream=torch.cuda.Stream(dev)), \
                graphs.probing(ring):
            for _ in range(16):
                graphs.probe("perception.lm_iter")
        for on in (False, True):
            ring.set(on)
            _replay_ms(torch, g16.replay, 1000, 1)
            res[f"probes16_{'on' if on else 'off'}_ms"] = _replay_ms(
                torch, g16.replay, 1000, 8)
        ring.set(False)
    return res


def cost_flag(torch, engine) -> dict:
    """The perception replay with the on-flag off and on, in turns."""
    ring = engine.trace.probes

    def median_ms():
        return statistics.median(_replay_ms(torch, engine.graphs[0].replay,
                                            100, 4))

    median_ms()
    rows = []
    for on in (False, True) * 3:
        ring.set(on)
        rows.append([on, median_ms()])
        ring.set(False)
        ring.drain()
    return {"perception_flag_ms": rows}


def cost_on(np, engine, run) -> dict:
    """scans/s (24 blocks of 24 replayed scans) and latency (24 blocks of
    12 scans), tracing on in every other block."""
    tr = engine.trace
    rates = {False: [], True: []}
    lats = {False: [], True: []}
    for b in range(48):
        on = b % 2 == 1
        if on:
            tr.on()
        if b < 24:
            rates[on].append(run.replay(0, 4, scans=24))
        else:
            lats[on] += run.latency(0, scans=12)[0]
        if on:
            tr.off()
            dropped = tr.drain()["dropped"]
            assert dropped == {"spans": 0, "records": 0}, dropped
    res = {}
    for on in (False, True):
        n = sum(m for m, _ in rates[on])
        w = sum(w for _, w in rates[on])
        lat = np.asarray(lats[on])
        res["on" if on else "off"] = {
            "scans_per_s": n / w, "blocks": len(rates[on]),
            "block_rates": [m / w for m, w in rates[on]],
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "latency_mean_ms": float(lat.mean()),
            "latency_scans": len(lat)}
    return res


def main(root: str, mode: str):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from slambench import caster, session

    with open(os.path.join(root, "slambench/configs/mulran-os1-64.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "slambench/traffic/fig8.replay.json")) as f:
        traffic = json.load(f)
    dev = torch.device("cuda")
    n = 40 if mode in ("off", "flag") else 1000
    drive = caster.make_drive(cfg["pipeline"]["lidar"], traffic, SEED, n, 1,
                              dev)
    system = session.System(cfg, dev)
    engine = system.engine
    run = session.Run(system, drive)
    run.warm_up(30)
    torch.cuda.synchronize()
    res = {"root": root, "mode": mode, "card": torch.cuda.get_device_name(),
           "package": os.path.dirname(
               sys.modules["sc_lego_loam_tpu_torch"].__file__)}
    if mode == "off":
        res.update(cost_off(torch, engine, dev))
    elif mode == "flag":
        res.update(cost_flag(torch, engine))
    else:
        res.update(cost_on(np, engine, run))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
