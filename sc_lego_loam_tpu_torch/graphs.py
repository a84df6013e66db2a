"""The engine's per-scan steps as CUDA graphs: the port's counterpart of the
JAX package's ``jax.jit`` on ``perception_step`` and ``mapping_step``
(``sc_lego_loam_tpu/pipeline.py:205,246``), one dispatch a step.

A ``StepGraph`` runs a step function ``fn(state, *inputs) -> (state,
*outputs)`` over static buffers:

- static inputs: the tensor leaves of the arguments (nested NamedTuples)
  at capture time, adopted as they are, not copied (the 3.1 GB keyframe
  and descriptor banks stay where they are);
- warm-up: the first call runs the step eagerly on the capture stream
  (the kernel library's build, cuBLAS's workspace for that stream); the
  second call captures and then replays, so no scan runs through the
  engine's state twice;
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
taken back and added once per replay.  A capture that fails raises; there
is no eager fallback (a step that synchronizes cannot be captured).

``CudaCapture`` captures with ``torch.cuda.graph``; ``EagerStandIn`` is the
CPU tests' stand-in, whose "replay" runs the step on the static buffers.
"""

from __future__ import annotations

import ctypes
import time

import torch

from .ops import cuda_knn, symeig


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


class CudaCapture:
    """Warm-up and capture on one side stream, into one memory pool shared
    by the engine's graphs (replayed in capture order: perception, then
    mapping on its outputs)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn):
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = fn()
        here.wait_stream(self.stream)
        return out

    def capture(self, fn):
        """Returns (replay () -> outputs, graph nodes or None, bytes the
        pool reserved)."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        try:                  # keep_graph: the node count reads the graph
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            kept = True
        except TypeError:     # a torch without keep_graph
            graph, kept = torch.cuda.CUDAGraph(), False
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        nodes = None
        if kept:
            graph.instantiate()
            cuda_knn.build()
            n = ctypes.c_ulonglong(0)
            err = cuda_knn._lib.graph_node_count(graph.raw_cuda_graph(),
                                                 ctypes.byref(n))
            nodes = n.value if err == 0 else None
        pool = torch.cuda.memory_reserved(self.device) - reserved

        def replay():
            graph.replay()
            return out

        replay.graph = graph
        return replay, nodes, pool


class EagerStandIn:
    """The CPU tests' stand-in for ``CudaCapture``: capturing keeps the
    function, replaying runs it on the static buffers."""

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        return fn, None, 0


class StepGraph:
    """``fn(state, *inputs) -> (state, *outputs)`` as a graph over static
    buffers (see the module docstring)."""

    def __init__(self, fn, backend, name: str):
        self.fn = fn
        self.backend = backend
        self.name = name
        self.calls = 0
        self.replays = 0
        self.nodes = None          # graph nodes, where the torch tells
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
            if self.calls == 0:
                self.calls += 1
                return self.backend.warm_up(lambda: self.fn(*args))
            self._capture(args)
        else:
            self._copy_in(flatten(args))
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
        # A state leaf gets a storage of its own: the write-back at the end
        # of the graph must not land in another leaf.
        seen, static = set(), []
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor) and i < n_state:
                if _storage(leaf) in seen:
                    leaf = leaf.clone()
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
        after = counts()
        self.delta = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        add_counts(self.delta, -1)


def summary(graphs) -> str:
    """One line of what the graphs hold."""
    return " ".join(
        f"{g.name}: nodes={g.nodes} capture_s={g.capture_s:.3f} "
        f"pool_bytes={g.pool_bytes} replays={g.replays} "
        f"launches_per_replay={dict(sorted(g.delta.items()))} "
        f"copied_leaves={g.copies.leaves} copied_bytes={g.copies.bytes} "
        f"largest_copy_bytes={g.copies.largest}"
        if g.captured else f"{g.name}: not captured" for g in graphs)
