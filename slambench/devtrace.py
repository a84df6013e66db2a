"""Reading a ``torch.profiler`` session of a stretch of scans: the device's
activity intervals (kernels, copies, fills), its busy time as their union
inside the stretch, the kernels run, the kernels that took most time and
the longest idle gaps, each gap named by the harness's ``record_function``
label the host was in when it began.
"""

from __future__ import annotations

from collections import defaultdict

STRETCH = "slambench.stretch"     # around the whole profiled stretch
HAND_IN = "slambench.hand_in"     # around each call into the program
WAIT = "slambench.wait"           # around each wait for the device
LABELS = (STRETCH, HAND_IN, WAIT)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the session."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns(), e.end_ns())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def read(prof, scans: int, top: int = 10) -> dict | None:
    """Summary of a profiled stretch of ``scans`` scans; None when the
    session holds no device activity inside the stretch."""
    device, host = [], []
    for name, is_dev, s, e in _events(prof):
        if name in LABELS:
            # A label's range also shows on the device's timeline (a GPU
            # user annotation): it is not device activity.
            if not is_dev:
                host.append((name, s, e))
        elif is_dev:
            device.append((name, s, e))
    stretch = [(s, e) for n, s, e in host if n == STRETCH]
    if not stretch or not device:
        return None
    w0, w1 = stretch[0]
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    if not device:
        return None
    merged = _merge([(s, e) for _, s, e in device])
    busy_ns = sum(e - s for s, e in merged)
    by_name = defaultdict(int)
    for n, s, e in device:
        by_name[n] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    edges = [w0] + [x for se in merged for x in se] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    inner = sorted((h for h in host if h[0] != STRETCH),
                   key=lambda h: h[1])

    def label(t):
        found = "slambench.host"
        for n, s, e in inner:
            if s > t:
                break
            if s <= t < e:
                found = n
        return found

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "scans": scans,
        "kernels": sum(1 for n, _, _ in device if _is_kernel(n)),
        "busy_s": busy_ns * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "device_ops": [[n[:200], v * 1e-9] for n, v in ops],
        "idle_gaps": [[label(s), (e - s) * 1e-9] for s, e in gaps[:top]],
    }
