"""The engines' steps as CUDA graphs: the port's counterpart of the JAX
package's ``jax.jit`` on ``perception_step``, ``mapping_step`` and
``loop_step`` (``sc_lego_loam_tpu/pipeline.py:205,246,303``) and on the
batch engine's steps, one dispatch a step.

A ``StepGraph`` runs a step function ``fn(state, *inputs) -> (state,
*outputs)`` over static buffers:

- static inputs: the tensor leaves of the arguments (nested NamedTuples)
  at capture time, adopted as they are, not copied (the 3.1 GB keyframe
  and descriptor banks stay where they are);
- warm-up: the first call runs the step eagerly on the capture stream
  (the kernel library's build, cuBLAS's workspace for that stream); the
  second call captures and then replays, so no scan runs through the
  engine's state twice (or, with ``warm_copy``, the first call warms up on
  copies and captures at once);
- capture in the engine's own memory pool; the captured function ends by
  writing the new state into the static state leaves (a leaf the step
  writes in place, as the banks, is already there), so after a replay the
  state IS the static buffers;
- replay copies in only the leaves whose storage is not already the
  static buffer: state replaced outside the graph (an eager loop tick, an
  IMU push, a property setter, a checkpoint load) reaches the static
  buffers there; ``load`` does it at once.

The kernels' launch counters (``cuda_knn.launches``, ``symeig.launches``)
count in Python, which a replay does not run: what a capture counted is
taken back and added once per replay, except a conditional body's
launches, which the body counts on the device (see ``cond``).  A capture
that fails raises; there is no eager fallback (a step that synchronizes
cannot be captured).

``CudaCapture`` captures with ``torch.cuda.graph``; ``EagerStandIn`` is the
CPU tests' stand-in, whose "replay" runs the step on the static buffers.

``cond(pred, body, init)`` is the JAX package's ``lax.cond(pred, body,
identity)`` for a step that branches on a device flag (the loop tick's
gates, the pose graph's per-iteration convergence).  What it does depends
on where it runs:

- ``"read"`` (eager, the CPU engine, a mesh): one host read of ``pred``,
  then ``body()`` or ``init`` as they are;
- ``"capture"`` (inside ``CudaCapture.capture``): a CUDA-graph conditional
  (IF) node whose body is captured from ``body()``; it writes into copies
  of ``init`` made before the node, so the false side leaves them as they
  were.  Conditional nodes nest (the pose graph's iterations sit inside
  the re-solve's gate).  Launches inside a body are counted on the device
  (an int64 counter the body increments) and read by ``flush_counts``;
- ``"select"`` (warm-up, and the CPU tests' stand-in): ``body()`` always
  runs and ``torch.where(pred, new, init)`` keeps its values only where
  ``pred`` holds: what the IF node computes, with no host read.  Warming a
  step up this way runs both sides of every gate before its capture.

``gate(pred)`` is the flag a ``cond`` takes: the host's ``bool`` in
``"read"`` (so a caller may skip what follows a false gate, as the eager
engine always has), the device tensor otherwise.

``probe(site, value)`` is one record of the engine's tracer
(``utils/profiling.py``) where the step runs it: a ``probe`` kernel
(``csrc/graph_nodes.cu``) on a CUDA device, captured into the graphs
always and recording only while its ``ProbeRing``'s on-flag is set, or a
host record on the CPU.  Only a step run inside ``probing(ring)`` records
(the engine's steps; the batch engine's ``vmap`` and a step called on its
own run none); a throwaway warm-up records nothing, and in "select" a
probe inside a gate's body records only where the body's effective
predicate holds, as ``_count_in_body`` weights its counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import numpy as np
import torch

from .ops import cuda_knn, symeig
from .utils.profiling import SITE_ID, SITES


def flatten(tree) -> list:
    """The leaves of nested tuples (NamedTuples included), in order."""
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in flatten(item)]
    return [tree]


def unflatten(like, leaves):
    """``like``'s structure over ``leaves`` (an iterator)."""
    if isinstance(like, tuple):
        items = [unflatten(item, leaves) for item in like]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(
            items)
    return next(leaves)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype
                      and a.device == b.device)


class CopyStats:
    """Leaves copied into static buffers outside a capture."""

    def __init__(self):
        self.leaves = 0
        self.bytes = 0
        self.largest = 0       # bytes of the largest leaf copied


def write(dsts, srcs, stats: CopyStats | None = None):
    """``dst.copy_(src)`` for every pair whose source is not already the
    destination.  A source inside the storage of any destination is cloned
    first, so that no copy reads a buffer another copy has written."""
    owned = {_storage(d) for d in dsts}
    pairs = []
    for d, s in zip(dsts, srcs):
        if _same(d, s):
            continue
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"a state leaf changed from {tuple(d.shape)} "
                             f"{d.dtype} to {tuple(s.shape)} {s.dtype}")
        pairs.append((d, s.clone() if s.device == d.device
                      and _storage(s) in owned else s))
    for d, s in pairs:
        d.copy_(s, non_blocking=True)
        if stats is not None:
            n = d.numel() * d.element_size()
            stats.leaves += 1
            stats.bytes += n
            stats.largest = max(stats.largest, n)


def counts() -> dict:
    """Every kernel launch counter, by (kernel, instantiation)."""
    out = {("knn", k): n for k, n in cuda_knn.launches.items()}
    out.update((("symeig", n), c) for n, c in symeig.launches.items())
    return out


def add_counts(delta: dict, sign: int = 1):
    for (name, key), n in delta.items():
        table = cuda_knn.launches if name == "knn" else symeig.launches
        table[key] += sign * n


# Launches inside conditional bodies are counted on the device, a slot per
# (kernel, instantiation): a replay may or may not run a body.
SLOTS = tuple(("knn", k) for k in cuda_knn.KS) + tuple(
    ("symeig", n) for n in symeig.launches)
_counters: dict = {}          # device -> (len(SLOTS),) int64


def device_counter(device) -> torch.Tensor:
    """The conditional bodies' launch counter on ``device``, made at first
    use (``CudaCapture`` makes it before any capture)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _counters:
        _counters[device] = torch.zeros(len(SLOTS), dtype=torch.int64,
                                        device=device)
    return _counters[device]


def flush_counts():
    """Add what the conditional bodies counted on the devices to the
    launch counters, and zero the device counters: one host read a
    device (the engines call it where they fetch the trajectory)."""
    for counter in _counters.values():
        values = counter.tolist()
        if any(values):
            add_counts({key: n for key, n in zip(SLOTS, values) if n})
            counter.zero_()


_modes = ["read"]             # what ``cond`` does here (module docstring)
_counting = [True]            # False: a throwaway warm-up counts nothing
_select_preds: list = []      # the predicates of the enclosing selects
_capturing = None             # the torch.cuda.CUDAGraph being captured


@contextlib.contextmanager
def cond_mode(mode: str):
    """``cond`` and ``gate`` in ``mode`` ("read", "select", "capture")
    inside the block."""
    if mode not in ("read", "select", "capture"):
        raise ValueError(f"unknown cond mode {mode!r}")
    _modes.append(mode)
    try:
        yield
    finally:
        _modes.pop()


def host_reads() -> bool:
    """Whether ``cond`` reads its predicate on the host here."""
    return _modes[-1] == "read"


def gate(pred: torch.Tensor):
    """``pred`` as ``cond`` takes it: read on the host in "read" mode."""
    return bool(pred) if host_reads() else pred


def _count_in_body(before: dict, device, taken):
    """Move the launches counted since ``before`` (a body's) from the host
    counters onto the device counter: inside a captured body as it is,
    weighted by ``taken`` (the body's effective predicate) in "select"."""
    after = counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if not delta:
        return
    add_counts(delta, -1)
    if not _counting[-1]:
        return
    counter = device_counter(device)
    for key, n in delta.items():
        slot = counter[SLOTS.index(key)]
        slot.add_(n if taken is None else taken.to(torch.int64) * n)


def cond(pred, body, init):
    """``body()`` where ``pred`` holds, else ``init`` (a tensor or nested
    tuples of tensors; ``body`` returns the same structure): JAX's
    ``lax.cond(pred, body, identity)``, as the module docstring says for
    each mode.  A Python bool ``pred`` is a plain ``if``."""
    if not isinstance(pred, torch.Tensor):
        return body() if pred else init
    mode = _modes[-1]
    if mode == "read":
        return body() if bool(pred) else init
    old = flatten(init)
    before = counts()
    if mode == "select":
        _select_preds.append(pred)
        try:
            new = flatten(body())
        finally:
            _select_preds.pop()
        taken = pred
        for outer in _select_preds:
            taken = taken & outer
        _count_in_body(before, pred.device, taken)
        out = [torch.where(pred, n, o) for n, o in zip(new, old, strict=True)]
        return unflatten(init, iter(out))
    cap = _capturing
    if cap is None or not pred.is_cuda or pred.dtype != torch.bool:
        raise RuntimeError("cond: a conditional node needs a CUDA bool "
                           "predicate inside CudaCapture.capture")
    out = [o.clone() for o in old]       # before the node: the false side
    body_stream = cap.body_stream()
    _check(cuda_knn._lib.graph_cond_begin(
        torch.cuda.current_stream(pred.device).cuda_stream, pred.data_ptr(),
        body_stream.cuda_stream, _THREAD_LOCAL), "graph_cond_begin")
    cap.depth += 1
    outer = cap.conditional
    types = (ctypes.c_ulonglong * len(NODE_TYPES))()
    try:
        with torch.cuda.stream(body_stream):
            for o, n in zip(out, flatten(body()), strict=True):
                o.copy_(n)
            _count_in_body(before, pred.device, None)
    finally:
        cap.depth -= 1
        # Node types only of a body that holds no conditional node itself
        # (graph_nodes.cu); of the others, the count.
        nested = cap.conditional > outer
        err = cuda_knn._lib.graph_cond_end(
            body_stream.cuda_stream, types, 0 if nested else len(NODE_TYPES))
    _check(err, "graph_cond_end")
    cap.conditional += 1
    counted = (("unclassified",), types[:1]) if nested else (NODE_TYPES,
                                                             types)
    for name, n in zip(*counted):
        cap.body_types[name] = cap.body_types.get(name, 0) + n
    return unflatten(init, iter(out))


class ProbeRing:
    """The device half of an engine's tracer: ``capacity`` records of
    (t_ns, site, value), the head that the probes advance, and the on-flag
    they read.  A full buffer takes no record; the head counts on, so
    ``drain`` reports the drops.  On the CPU the records are kept on the
    host, stamped with ``time.perf_counter_ns()``."""

    CLOCK_BRACKETS = 20

    def __init__(self, device, capacity: int = 1 << 17):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.capacity = capacity
        self.cuda = device.type == "cuda"
        self.flag = torch.zeros(1, dtype=torch.int32, device=device)
        self._last_clock = None    # (device ns, offset ns) of the last drain
        if self.cuda:
            cuda_knn.build()
            self.head = torch.zeros(1, dtype=torch.int32, device=device)
            self.buf = torch.zeros((capacity, 2), dtype=torch.int64,
                                   device=device)
            self._clock = (
                torch.ones(1, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device),
                torch.zeros((self.CLOCK_BRACKETS, 2), dtype=torch.int64,
                            device=device))
        else:
            self._flag = self.flag.numpy()     # read without a tensor op
            self._host = []
            self._count = 0

    def set(self, on: bool):
        """Turn the probes on or off: a fill on the current stream, ordered
        with the replays; no host read."""
        self.flag.fill_(1 if on else 0)

    def count(self) -> int:
        """Records taken since the last drain, dropped ones included (a
        host read)."""
        return int(self.head.item()) if self.cuda else self._count

    def record(self, site: int, value, taken):
        if not self.cuda:
            if self._flag[0]:
                self._count += 1
                if len(self._host) < self.capacity:
                    self._host.append((site, time.perf_counter_ns(),
                                       None if value is None
                                       else value.detach().clone(),
                                       None if taken is None
                                       else taken.clone()))
            return
        kind, ptr = _value_kind(value)
        _check(cuda_knn._lib.graph_probe(
            torch.cuda.current_stream(self.device).cuda_stream,
            self.flag.data_ptr(), self.buf.data_ptr(), self.head.data_ptr(),
            self.capacity, site, ptr, kind,
            None if taken is None else taken.data_ptr()), "graph_probe")

    def clock(self):
        """(device ns, offset ns, error ns): ``%globaltimer`` minus
        ``time.perf_counter_ns()``, from the tightest of
        ``CLOCK_BRACKETS`` brackets (a synchronize, a host read, one probe,
        a synchronize, a host read) and its half-width."""
        on, head, buf = self._clock
        head.zero_()
        brackets = []
        for _ in range(self.CLOCK_BRACKETS):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            _check(cuda_knn._lib.graph_probe(
                torch.cuda.current_stream(self.device).cuda_stream,
                on.data_ptr(), buf.data_ptr(), head.data_ptr(),
                self.CLOCK_BRACKETS, 0, None, 0, None), "graph_probe")
            torch.cuda.synchronize(self.device)
            brackets.append((h0, time.perf_counter_ns()))
        d = buf[:, 0].cpu().numpy()
        k = min(range(len(brackets)),
                key=lambda i: brackets[i][1] - brackets[i][0])
        h0, h1 = brackets[k]
        return int(d[k]), int(d[k]) - (h0 + h1) // 2, (h1 - h0) // 2

    def drain(self) -> dict:
        """The records since the last drain, oldest first, as (site name,
        t_ns on the ``perf_counter_ns`` clock, value), and empty the
        buffer.  On the device: a synchronize, then the clock's offset
        measured now (``clock``); where an earlier drain measured it too,
        the offset is interpolated linearly between the two in device time
        (``drift_ns``: how far they differ), so a drain just after
        ``set(True)`` gives a phase its first point.  The only host reads
        of the tracer are here."""
        if not self.cuda:
            recs = [(SITES[s], t, _host_value(v)) for s, t, v, taken
                    in self._host if taken is None or bool(taken)]
            dropped = self._count - len(self._host)
            self._host, self._count = [], 0
            return {"records": recs, "offset_ns": 0, "error_ns": 0,
                    "dropped": dropped, "drift_ns": 0}
        torch.cuda.synchronize(self.device)
        n = int(self.head.item())
        rows = self.buf[:min(n, self.capacity)].cpu().numpy()
        self.head.zero_()
        d1, off1, err = self.clock()
        t = rows[:, 0]
        offset = np.full(len(t), off1, np.int64)
        drift = 0
        if self._last_clock is not None:
            d0, off0 = self._last_clock
            drift = off1 - off0
            if d1 > d0:
                offset = off0 + np.round(
                    (t - d0) * (drift / (d1 - d0))).astype(np.int64)
        self._last_clock = (d1, off1)
        sites = (rows[:, 1] >> 32).tolist()
        values = (rows[:, 1] & 0xFFFFFFFF).astype(np.uint32).view(
            np.float32).tolist()
        recs = [(SITES[s], int(h), float(v))
                for s, h, v in zip(sites, (t - offset).tolist(), values)]
        return {"records": recs, "offset_ns": off1, "error_ns": err,
                "dropped": max(0, n - self.capacity), "drift_ns": drift}


def _host_value(v) -> float:
    if v is None:
        return 0.0
    if v.dtype == torch.bool and v.numel() == 2:
        return float(v[0]) + 2.0 * float(v[1])
    return float(v)


# A probe's value: the kernel's kind code by dtype (csrc/graph_nodes.cu).
_KINDS = {torch.bool: 1, torch.int32: 2, torch.float32: 3}


def _value_kind(value):
    if value is None:
        return 0, None
    if value.dtype == torch.bool and value.numel() == 2 \
            and value.is_contiguous():
        return 4, value.data_ptr()
    if value.numel() != 1 or value.dtype not in _KINDS:
        raise ValueError(f"probe: a value of shape {tuple(value.shape)} "
                         f"{value.dtype}: one bool, int or float32 (or two "
                         "bools) only")
    return _KINDS[value.dtype], value.data_ptr()


_probe_rings: list = [None]   # the ring of the step running now


@contextlib.contextmanager
def probing(ring: ProbeRing | None):
    """``probe`` records into ``ring`` inside the block."""
    _probe_rings.append(ring)
    try:
        yield
    finally:
        _probe_rings.pop()


def probe(site: str, value: torch.Tensor | None = None):
    """One record at ``site`` (``utils.profiling.SITES``) with ``value`` (a
    bool, int or float32 scalar the step holds, or two bools), read when
    the probe runs (module docstring)."""
    ring = _probe_rings[-1]
    if ring is None or not _counting[-1]:
        return
    taken = None
    if _modes[-1] == "select" and _select_preds:
        taken = _select_preds[0]
        for pred in _select_preds[1:]:
            taken = taken & pred
    ring.record(SITE_ID[site], value, taken)


# cudaGraphNodeType, in its order ("unclassified": the nodes of a body
# that holds conditional nodes itself).
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_signal", "ext_wait",
              "mem_alloc", "mem_free", "batch_mem_op", "conditional")


_THREAD_LOCAL = 1             # cudaStreamCaptureModeThreadLocal
_MAX_DEPTH = 4                # conditional nodes nested at most this deep
_body_streams: dict = {}      # device -> streams, one a nesting depth


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


# The allocator's switches, by their names in the torch versions that have
# them: route every allocation of this thread into a capture's pool.
_END_POOL = ("_cuda_endAllocateToPool", "_cuda_endAllocateCurrentStreamToPool")
_THREAD_POOL = "_cuda_beginAllocateCurrentThreadToPool"


def require_conditional_nodes():
    """Raise unless conditional nodes can be captured here: CUDA 12.4 or
    later, and the allocator switch that keeps a body's allocations (made
    on a stream of its own) in the capture's pool.  A graphed engine has
    no host-read fallback."""
    version = tuple(int(x) for x in
                    (torch.version.cuda or "0.0").split(".")[:2])
    missing = [name for name in (_THREAD_POOL,) if not hasattr(torch._C, name)]
    if not any(hasattr(torch._C, name) for name in _END_POOL):
        missing.append(_END_POOL[0])
    if missing or version < (12, 4):
        raise RuntimeError(
            f"CUDA-graph conditional nodes unavailable (torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}, missing "
            f"{missing}): a graphed engine needs them; pass eager=True")


def _route_thread_to_pool(device: torch.device, pool):
    """Inside ``torch.cuda.graph``: the capture's pool takes every
    allocation of this thread, on any stream (a conditional body is
    captured on a stream of its own); the capture's end removes it."""
    end = next(getattr(torch._C, n) for n in _END_POOL if hasattr(torch._C, n))
    end(device.index, pool)
    getattr(torch._C, _THREAD_POOL)(device.index, pool)


class CudaCapture:
    """Warm-up and capture on one side stream, into one memory pool shared
    by the engine's graphs (replayed in capture order: perception, then
    mapping on its outputs)."""

    def __init__(self, device):
        require_conditional_nodes()
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        device_counter(self.device)
        cuda_knn.build()
        if self.device not in _body_streams:
            streams = []
            for _ in range(_MAX_DEPTH):
                ptr = ctypes.c_void_p()
                _check(cuda_knn._lib.graph_stream_create(ctypes.byref(ptr)),
                       "graph_stream_create")
                streams.append(torch.cuda.ExternalStream(
                    ptr.value, device=self.device))
            _body_streams[self.device] = streams
        self.depth = 0             # conditional nodes open in the capture
        self.conditional = 0       # conditional nodes in the capture
        self.body_types = {}       # nodes inside their bodies, by type

    def body_stream(self) -> torch.cuda.ExternalStream:
        """The stream the next conditional body is captured on."""
        if self.depth >= _MAX_DEPTH:
            raise RuntimeError(f"conditional nodes nested deeper than "
                               f"{_MAX_DEPTH}")
        return _body_streams[self.device][self.depth]

    def warm_up(self, fn):
        """``fn()`` eagerly on the capture stream, every ``cond`` in
        "select" mode: both sides of each gate run before the capture."""
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream), cond_mode("select"):
            out = fn()
        here.wait_stream(self.stream)
        return out

    def capture(self, fn):
        """Returns (replay () -> outputs, graph nodes or None, bytes the
        pool reserved); ``replay.census`` is (conditional nodes, nodes
        inside their bodies), counted into the nodes too."""
        global _capturing
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # keep_graph: the node count reads the graph.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.conditional, self.body_types = 0, {}
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            _route_thread_to_pool(self.device, self.pool)
            _capturing = self
            try:
                with cond_mode("capture"):
                    out = fn()
            finally:
                _capturing = None
        try:
            graph.instantiate()
        except Exception as err:      # torch.AcceleratorError among them
            raise RuntimeError(
                f"instantiating a graph with {self.conditional} conditional "
                f"nodes failed; nodes in their bodies by type: "
                f"{ {k: v for k, v in self.body_types.items() if v} }"
            ) from err
        n = ctypes.c_ulonglong(0)
        err = cuda_knn._lib.graph_node_count(graph.raw_cuda_graph(),
                                             ctypes.byref(n))
        in_bodies = sum(self.body_types.values())
        nodes = n.value + in_bodies if err == 0 else None
        pool = torch.cuda.memory_reserved(self.device) - reserved

        def replay():
            graph.replay()
            return out

        replay.graph = graph
        replay.census = (self.conditional, in_bodies)
        return replay, nodes, pool


class EagerStandIn:
    """The CPU tests' stand-in for ``CudaCapture``: capturing keeps the
    function, replaying runs it on the static buffers; every ``cond`` in
    it is in "select" mode, as in ``CudaCapture.warm_up``."""

    def warm_up(self, fn):
        with cond_mode("select"):
            return fn()

    def capture(self, fn):
        def replay():
            with cond_mode("select"):
                return fn()

        return replay, None, 0


def small_copy(tree, limit: int = 64 << 20):
    """``tree`` with its tensor leaves under ``limit`` bytes copied and the
    larger ones shared."""
    return unflatten(tree, iter(
        x.clone() if isinstance(x, torch.Tensor)
        and x.numel() * x.element_size() < limit else x
        for x in flatten(tree)))


class StepGraph:
    """``fn(state, *inputs) -> (state, *outputs)`` as a graph over static
    buffers (see the module docstring).

    ``warm_copy`` (args -> args): the first call warms the step up on what
    it returns, counting no launch, then captures on the real arguments
    and replays, so a step that runs seldom (the loop tick) is a graph
    from its first call.  ``small_copy`` serves a step that writes only
    its small leaves in place and only reads the large ones (the banks)."""

    def __init__(self, fn, backend, name: str, warm_copy=None):
        self.fn = fn
        self.backend = backend
        self.name = name
        self.warm_copy = warm_copy
        self.calls = 0
        self.replays = 0
        self.nodes = None          # graph nodes, conditional bodies too
        self.census = None         # (conditional nodes, nodes in bodies)
        self.capture_s = None      # seconds the capture took
        self.pool_bytes = 0        # memory the capture reserved
        self.delta = {}            # kernel launches a replay makes
        self.copies = CopyStats()  # leaves copied in before replays
        self._replay = None
        self._static = None        # their leaves, static
        self._n_state = 0

    @property
    def captured(self) -> bool:
        return self._replay is not None

    def __call__(self, *args):
        if self._replay is None:
            if self.calls == 0 and self.warm_copy is None:
                self.calls += 1
                return self.backend.warm_up(lambda: self.fn(*args))
            if self.calls == 0:
                copies = self.warm_copy(args)
                before = counts()
                _counting.append(False)
                try:
                    self.backend.warm_up(lambda: self.fn(*copies))
                finally:
                    _counting.pop()
                after = counts()
                add_counts({k: after[k] - before[k] for k in after}, -1)
            self._capture(args)
        else:
            self._copy_in(flatten(args))
        self.calls += 1
        self.replays += 1
        out = self._replay()
        add_counts(self.delta)
        return out

    @property
    def static_inputs(self) -> list:
        """The static buffers of the inputs after the state (tensor leaves
        only), in argument order: what ``replay`` reads."""
        return [x for x in self._static[self._n_state:]
                if isinstance(x, torch.Tensor)]

    def replay(self):
        """One replay of the captured graph on what the static buffers hold
        now, with no copy-in (a caller that writes ``static_inputs`` itself
        times that copy apart)."""
        self.calls += 1
        self.replays += 1
        out = self._replay()
        add_counts(self.delta)
        return out

    def load(self, state):
        """``state`` in the static state buffers (copied where a leaf is
        not already there); returns the static state."""
        if self._replay is None:
            return state
        leaves = flatten(state)
        if len(leaves) != self._n_state:
            raise ValueError(f"{self.name}: the state has {len(leaves)} "
                             f"leaves, the graph {self._n_state}")
        write(self._static[:self._n_state], leaves, self.copies)
        return self._state

    def _copy_in(self, leaves):
        if len(leaves) != len(self._static):
            raise ValueError(f"{self.name}: {len(leaves)} argument leaves, "
                             f"the graph has {len(self._static)}")
        dsts, srcs = [], []
        for d, s in zip(self._static, leaves):
            if isinstance(d, torch.Tensor):
                dsts.append(d)
                srcs.append(s)
            elif s is not d and s != d:
                raise ValueError(f"{self.name}: a constant argument changed "
                                 f"from {d!r} to {s!r}")
        write(dsts, srcs, self.copies)

    def _capture(self, args):
        leaves = flatten(args)
        n_state = len(flatten(args[0]))
        # A state leaf gets a dense storage of its own: the write-back at
        # the end of the graph must not land in another leaf, nor twice in
        # one place (``vmap`` may return an expanded leaf).
        seen, static = set(), []
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor) and i < n_state:
                if _storage(leaf) in seen or not leaf.is_contiguous():
                    leaf = leaf.clone(memory_format=torch.contiguous_format)
                seen.add(_storage(leaf))
            static.append(leaf)
        self._static, self._n_state = static, n_state
        static_args = unflatten(args, iter(static))
        self._state = static_args[0]
        state_leaves = static[:n_state]

        def body():
            out = self.fn(*static_args)
            write(state_leaves, flatten(out[0]))
            return (self._state, *out[1:])

        before = counts()
        t0 = time.perf_counter()
        self._replay, self.nodes, self.pool_bytes = self.backend.capture(body)
        self.capture_s = time.perf_counter() - t0
        self.census = getattr(self._replay, "census", None)
        after = counts()
        self.delta = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        add_counts(self.delta, -1)


def summary(graphs) -> str:
    """One line of what the graphs hold."""
    return " ".join(
        f"{g.name}: nodes={g.nodes} conditional_nodes="
        f"{None if g.census is None else g.census[0]} nodes_in_bodies="
        f"{None if g.census is None else g.census[1]} "
        f"capture_s={g.capture_s:.3f} "
        f"pool_bytes={g.pool_bytes} replays={g.replays} "
        f"launches_per_replay={dict(sorted(g.delta.items()))} "
        f"copied_leaves={g.copies.leaves} copied_bytes={g.copies.bytes} "
        f"largest_copy_bytes={g.copies.largest}"
        if g.captured else f"{g.name}: not captured" for g in graphs)
