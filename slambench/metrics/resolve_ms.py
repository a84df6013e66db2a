"""resolve_ms (ms): the device ms of the loop tick's pose-graph re-solve
body, from its ``begin`` to its ``end`` record, the mean over the program
phase's closing ticks (``rec["program"]``); None where no tick closed."""


def read(rec):
    p = rec.get("program")
    ms = []
    for s in (p or {}).get("scans", []):
        tick = s.get("loop_tick")
        if tick and tick["closed"] and tick["resolve"] \
                and tick["resolve"][1] is not None:
            ms.append((tick["resolve"][1] - tick["resolve"][0]) * 1e-6)
    return sum(ms) / len(ms) if ms else None
