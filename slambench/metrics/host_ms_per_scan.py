"""host_ms_per_scan (ms): host wall time of one call into the program
(``Run.device_calls``: after a synchronize, with only a device sleep on
the stream), the mean over the traced scans: the launch layer's own cost
(the scan's staging and the graph launches)."""


def read(rec):
    host = rec.get("host_ms")
    return sum(host) / len(host) if host else None
