"""mapping_tick_ms (ms): the mean device ms of the traced calls on which a
mapping tick ran and no loop tick, minus the mean of those on which no
mapping tick ran (perception_ms)."""


def read(rec):
    d, m, lp = rec["device_ms"], rec["map_moved"], rec["loop_moved"]
    tick = [x for x, a, b in zip(d, m, lp) if a and not b]
    plain = [x for x, a in zip(d, m) if not a]
    if not tick or not plain:
        return None
    return sum(tick) / len(tick) - sum(plain) / len(plain)
