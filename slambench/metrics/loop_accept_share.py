"""loop_accept_share (ratio): the loop ticks' ICP verifications that
accepted a factor over those that ran, in the program phase, from the
records at each verification body's end (``rec["program"]``); None where
no verification ran."""


def read(rec):
    p = rec.get("program")
    ran = accepted = 0
    for s in (p or {}).get("scans", []):
        tick = s.get("loop_tick")
        for _, end, ok in (tick["verify"] if tick else []):
            if end is not None:
                ran += 1
                accepted += bool(ok)
    return accepted / ran if ran else None
