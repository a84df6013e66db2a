"""sync_gap_ms (ms): what a latency cell's client waits for besides the
device: each scan's hand-in to fused pose on the host, minus the mean
device ms of calls of its kind (no tick, a mapping tick, a loop tick that
closed no loop, one that closed) timed alone between CUDA events, the
mean over the client's scans."""


def _mean(v):
    return sum(v) / len(v) if v else None


def _kind(a, b, c):
    return 3 if c else (2 if b else (1 if a else 0))


def read(rec):
    lat = rec.get("handin_ms")
    if not lat:
        return None
    dev = {k: _mean([x for x, a, b, c in
                     zip(rec["device_ms"], rec["map_moved"],
                         rec["loop_moved"], rec["close_moved"])
                     if _kind(a, b, c) == k]) for k in range(4)}
    gaps = [h - dev[k] for h, k in
            ((h, _kind(a, b, c)) for h, a, b, c in
             zip(lat, rec["handin_map"], rec["handin_loop"],
                 rec["handin_close"]))
            if dev[k] is not None]
    return _mean(gaps)
