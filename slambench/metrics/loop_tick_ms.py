"""loop_tick_ms (ms): the mean device ms of the traced calls on which a
loop tick ran and closed no loop (no candidate, or none verified), minus
the mean of those on which a mapping tick ran and no loop tick: the cost
of a loop tick that leaves the graph as it was."""


def read(rec):
    d, m, lp, c = (rec["device_ms"], rec["map_moved"], rec["loop_moved"],
                   rec["close_moved"])
    loop = [x for x, b, k in zip(d, lp, c) if b and not k]
    tick = [x for x, a, b in zip(d, m, lp) if a and not b]
    if not loop or not tick:
        return None
    return sum(loop) / len(loop) - sum(tick) / len(tick)
