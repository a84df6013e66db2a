"""perception_ms (ms): device ms between CUDA events around a call timed
alone on the device (``Run.device_calls``) on which no mapping tick ran:
the scan's upload and the perception step, the mean over those scans."""


def read(rec):
    v = [d for d, m in zip(rec["device_ms"], rec["map_moved"]) if not m]
    return sum(v) / len(v) if v else None
