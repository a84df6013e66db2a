"""Per-stage timing and device traces (port of
``sc_lego_loam_tpu/utils/profiling.py``).

``StageTimer`` aggregates wall-clock samples per pipeline stage.  On a CUDA
device the engine's stages return once their kernels are ENQUEUED, so a
stage's sample is the host's time to launch it (plus any host sync inside
it), not the device's time to run it; the engine is launch-bound, so the two
are close, but only a window that ends in ``torch.cuda.synchronize()``
measures the device.  ``device_trace`` wraps ``torch.profiler``; nothing
opens one by default, because after a first profiler session every later
kernel launch of the process is slower.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    """Aggregating wall-clock timer: one row per pipeline stage (host
    clock around asynchronous launches, see the module docstring)."""

    def __init__(self):
        self._samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._samples[name].append(seconds)

    def summary(self, skip_first: int = 1) -> dict:
        """Per-stage stats (seconds), skipping warm-up samples."""
        out = {}
        for name, xs in self._samples.items():
            xs = xs[skip_first:] if len(xs) > skip_first else xs
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "total": float(a.sum()),
            }
        return out

    def table(self, skip_first: int = 1) -> str:
        rows = ["stage                     n     mean     p50      p95    total"]
        for name, s in sorted(self.summary(skip_first).items(),
                              key=lambda kv: -kv[1]["total"]):
            rows.append(
                f"{name:<22} {s['n']:5d} {s['mean']*1e3:7.2f}ms "
                f"{s['p50']*1e3:7.2f}ms {s['p95']*1e3:7.2f}ms "
                f"{s['total']:7.2f}s")
        return "\n".join(rows)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card); writes ``<logdir>/trace.json`` (Chrome trace format) and yields
    the profiler, whose ``key_averages()`` the caller may read after the
    block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
