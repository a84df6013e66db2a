"""The engine's tracer (``utils/profiling.StageTimer``, ``graphs.probe``,
``graphs.ProbeRing``): tracing changes no output bit, records nothing while
it is off, and records, scan by scan, the sites the steps pass, nested
host spans and one perception ``begin`` a call.  The steps run through
``graphs.EagerStandIn`` (every gate in "select" mode, as in a warm-up), on
the tiny configuration; the loop tick on the hand-made states of
tests/torch_keyframes.py.  The card tests run the probe kernel and the
clock conversion."""

import time

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch import graphs, pipeline as tp
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import convert, profiling, synthetic

torch.set_num_threads(1)

N_SCANS = 2       # t = 0 and 0.1 s: a mapping tick, then a scan without one
PERCEPTION = (["perception.begin", "perception.frontend",
               "perception.features"] + ["perception.lm_iter"] * 12
              + ["perception.end"])
MAPPING = (["mapping.begin", "mapping.submap"] + ["mapping.lm_iter"] * 8
           + ["mapping.end"])


@pytest.fixture(scope="module")
def drives():
    """The same scans through two engines, tracing off and on."""
    cfg = tiny_test_config()
    assert cfg.odom.max_iterations == 12 and cfg.mapping.max_iterations == 8
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, N_SCANS, seed=0, trajectory="straight")
    out = {}
    for on in (False, True):
        engine = SlamEngine(cfg, device="cpu")
        engine.use_graphs(graphs.EagerStandIn())
        if on:
            engine.trace.on()
        poses = [engine.process_scan(scans[i], valids[i], t=0.1 * i).clone()
                 for i in range(N_SCANS)]
        count = engine.trace.probes.count()
        out[on] = (engine, poses, count, engine.trace.drain())
    return out


def _by_scan(records):
    scans = []
    for site, _, value in records:
        if site == "perception.begin":
            scans.append([])
        scans[-1].append((site, value))
    return scans


def test_tracing_changes_no_output_bit(drives):
    (off, p_off, _, _), (on, p_on, _, _) = drives[False], drives[True]
    for a, b in zip(p_off, p_on):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for name in ("p", "m"):
        leaves_off = graphs.flatten(getattr(off, name))
        leaves_on = graphs.flatten(getattr(on, name))
        for i, (a, b) in enumerate(zip(leaves_off, leaves_on, strict=True)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"{name} leaf {i}")


def test_off_records_nothing(drives):
    _, _, count, drained = drives[False]
    assert count == 0
    assert drained["spans"] == [] and drained["records"] == []
    assert drained["scans"] == []
    _, _, count_on, _ = drives[True]
    assert count_on > 0


def test_records_follow_the_steps(drives):
    engine, _, count, drained = drives[True]
    assert drained["dropped"] == {"spans": 0, "records": 0}
    assert count == len(drained["records"])
    per_scan = _by_scan(drained["records"])
    assert len(per_scan) == N_SCANS
    mapped = [True] + [False] * (N_SCANS - 1)
    assert engine.map_ticks == sum(mapped)
    for recs, tick in zip(per_scan, mapped):
        want = PERCEPTION + (MAPPING if tick else [])
        assert [s for s, _ in recs] == want
        for site in ("perception.lm_iter", "mapping.lm_iter"):
            done = [v for s, v in recs if s == site]
            assert done == sorted(done), (site, done)   # monotone
    times = [t for _, t, _ in drained["records"]]
    assert times == sorted(times)
    view = drained["scans"]
    assert [s["scan"] for s in view] == list(range(N_SCANS))
    for s, tick in zip(view, mapped):
        assert len(s["lm"]) == 12
        assert (s["mapping"] is not None) == tick
        assert len(s["map_lm"]) == (8 if tick else 0)
        assert s["loop"] is None and s["loop_tick"] is None
        b, e = s["perception"]
        assert s["host"]["perception_step"][0] <= b <= e \
            <= s["host"]["perception_step"][1]


def test_host_spans_nest_in_the_call(drives):
    _, _, _, drained = drives[True]
    spans = drained["spans"]
    roots = [s for s in spans if s["name"] == "process_scan"]
    assert len(roots) == N_SCANS == len(drained["scans"])
    assert [r["parent"] for r in roots] == [-1] * N_SCANS
    for s in spans:
        if s["name"] == "process_scan":
            continue
        parent = spans[s["parent"]]
        assert parent["name"] == "process_scan"
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
        assert s["scan"] == parent["scan"]
    names = [s["name"] for s in spans]
    assert names.count("stage_scan") == names.count("perception_step") \
        == N_SCANS
    assert names.count("mapping_step") == 1
    assert "loop_step" not in names


@pytest.fixture(scope="module")
def loop_state():
    from torch_keyframes import loop_state, loop_tick_cfg

    return loop_state(loop_tick_cfg(tiny_test_config, "closed"), "closed")


@pytest.mark.parametrize("outcome", ("closed", "rejected"))
def test_loop_records_follow_the_gates(loop_state, outcome):
    """In "select" every body runs; its records stay only where the gate
    took it: the radius verification (not taken) and the GN iterations
    after convergence leave none, nor the re-solve of a rejected tick."""
    from torch_keyframes import loop_tick_cfg, no_host_reads

    cfg = loop_tick_cfg(tiny_test_config, outcome)
    ring = graphs.ProbeRing("cpu")

    def tick(on, mode):
        ring.set(on)
        state = convert.mapper_state(loop_state, "cpu")
        with graphs.cond_mode(mode), graphs.probing(ring):
            if mode == "select":
                with no_host_reads():
                    out = tp.loop_step(cfg, state)
            else:
                out = tp.loop_step(cfg, state)
        return out, ring.drain()

    traced, drained = tick(True, "select")
    # Against a tick with tracing off: the closing one gated the same way,
    # the rejected one read on the host (the same bits, as
    # tests/test_torch_loop_graph.py holds).
    plain, none = tick(False, "select" if outcome == "closed" else "read")
    for i, (a, b) in enumerate(zip(graphs.flatten(traced),
                                   graphs.flatten(plain), strict=True)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=str(i))
    assert none["records"] == [] and none["dropped"] == 0
    sites = [s for s, _, _ in drained["records"]]
    values = {s: v for s, _, v in drained["records"]}
    closed = outcome == "closed"
    assert int(traced.loops_closed) == closed
    head = ["loop.begin", "loop.detect", "loop.verify_begin",
            "loop.verify_end"]
    if closed:
        gn = [v for s, _, v in drained["records"] if s == "loop.gn_iter"]
        assert 1 < len(gn) < cfg.posegraph.max_gn_iterations
        assert gn == sorted(gn) and gn[-1] == 1.0
        assert sites == head + ["loop.resolve_begin"] + [
            "loop.gn_iter"] * len(gn) + ["loop.resolve_end", "loop.end"]
    else:
        assert sites == head + ["loop.end"]
    assert values["loop.detect"] == 1.0          # the Scan Context hit
    assert values["loop.verify_end"] == float(closed)
    assert values["loop.end"] == float(closed)


def test_scan_view_reads_the_records():
    """The per-scan view of hand-written spans and records."""
    spans = [
        {"name": "process_scan", "start_ns": 0, "end_ns": 90, "parent": -1,
         "scan": 4},
        {"name": "perception_step", "start_ns": 10, "end_ns": 20,
         "parent": 0, "scan": 4},
        {"name": "loop_step", "start_ns": 30, "end_ns": 40, "parent": 0,
         "scan": 4},
    ]
    recs = [("perception.begin", 100, 0.0)] + [
        ("perception.lm_iter", 110 + k, float(k >= 6)) for k in range(12)
    ] + [("perception.end", 130, 0.0), ("loop.begin", 200, 0.0),
         ("loop.detect", 210, 3.0), ("loop.verify_begin", 220, 0.0),
         ("loop.verify_end", 230, 0.0), ("loop.verify_begin", 240, 0.0),
         ("loop.verify_end", 250, 1.0), ("loop.resolve_begin", 260, 0.0),
         ("loop.gn_iter", 270, 0.0), ("loop.gn_iter", 280, 1.0),
         ("loop.resolve_end", 290, 0.0), ("loop.end", 300, 1.0)]
    (s,) = profiling.scan_view(spans, recs)
    assert s["scan"] == 4 and s["host"]["call"] == [0, 90]
    assert s["host"]["loop_step"] == [30, 40]
    assert s["perception"] == [100, 130] and s["mapping"] is None
    assert s["loop"] == [200, 300]
    assert [d for _, d in s["lm"]] == [False] * 6 + [True] * 6
    tick = s["loop_tick"]
    assert tick["detected"] == 3 and tick["closed"]
    assert tick["verify"] == [[220, 230, False], [240, 250, True]]
    assert tick["resolve"] == [260, 290]
    assert tick["gn"] == [[270, False], [280, True]]


def test_drain_holds_calls_and_graphs_to_one_count():
    """A perception graph that ran with no call into the engine around it
    (or the reverse) is a fault of the trace, and ``drain`` says so."""
    timer = profiling.StageTimer(probes=graphs.ProbeRing("cpu"))
    timer.scan = 0
    with timer.stage("process_scan"):
        pass
    with pytest.raises(RuntimeError, match="perception graphs"):
        timer.drain()
    with timer.stage("process_scan"):
        with graphs.probing(timer.probes):
            graphs.probe("perception.begin")
    assert len(timer.drain()["scans"]) == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_kernel_on_the_card(card):
    """Off, a probe takes no slot; on, each records its site and value in
    launch order, eagerly and replayed from a CUDA graph; in "select" a
    probe records only where its gate holds; a full buffer counts its
    drops."""
    ring = graphs.ProbeRing(card, capacity=8)
    vals = [torch.tensor(True, device=card),
            torch.tensor(7, dtype=torch.int32, device=card),
            torch.tensor(2.5, device=card),
            torch.tensor([True, True], device=card)]

    def probes():
        with graphs.probing(ring):
            graphs.probe("loop.begin")
            for v in vals:
                graphs.probe("loop.detect", v)

    probes()
    assert ring.count() == 0
    ring.set(True)
    probes()
    got = ring.drain()
    assert [(s, v) for s, _, v in got["records"]] == [
        ("loop.begin", 0.0), ("loop.detect", 1.0), ("loop.detect", 7.0),
        ("loop.detect", 2.5), ("loop.detect", 3.0)]
    assert got["dropped"] == 0

    stream = torch.cuda.Stream(card)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        probes()
    ring.set(False)
    graph.replay()
    assert ring.count() == 0
    ring.set(True)
    graph.replay()
    graph.replay()
    got = ring.drain()
    assert len(got["records"]) == 8 and got["dropped"] == 2

    with graphs.cond_mode("select"), graphs.probing(ring):
        graphs._select_preds.append(torch.tensor(False, device=card))
        try:
            graphs.probe("loop.verify_begin")
        finally:
            graphs._select_preds.pop()
        graphs.probe("loop.end")
    assert [s for s, _, _ in ring.drain()["records"]] == ["loop.end"]
    ring.set(False)


@pytest.mark.cuda
def test_clock_converts_onto_the_host_clock(card):
    """A probe's converted time lies between the host's reads around it,
    within the conversion's stated error."""
    ring = graphs.ProbeRing(card)
    ring.set(True)
    brackets = []
    for _ in range(5):
        torch.cuda.synchronize(card)
        h0 = time.perf_counter_ns()
        with graphs.probing(ring):
            graphs.probe("perception.begin")
        torch.cuda.synchronize(card)
        brackets.append((h0, time.perf_counter_ns()))
        time.sleep(0.01)
    got = ring.drain()
    ring.set(False)
    err = got["error_ns"]
    assert 0 <= err < 1_000_000
    for (h0, h1), (_, t, _) in zip(brackets, got["records"], strict=True):
        assert h0 - err <= t <= h1 + err, (h0, t, h1, err)
