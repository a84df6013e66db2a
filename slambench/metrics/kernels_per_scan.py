"""kernels_per_scan (kernels/scan): device kernels (copies and fills left
out) in the profiled stretch of the traced run, over its scans: what the
graphs' nodes launch; a stretch of 90 scans holds 30 mapping ticks and 10
loop ticks."""


def read(rec):
    p = rec.get("profile")
    return p["kernels"] / p["scans"] if p and p["scans"] else None
