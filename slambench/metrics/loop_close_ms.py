"""loop_close_ms (ms): the mean device ms of the traced calls whose loop
tick closed a loop (a factor verified and the pose graph re-solved),
minus the mean of those on which a mapping tick ran and no loop tick."""


def read(rec):
    d, m, lp, c = (rec["device_ms"], rec["map_moved"], rec["loop_moved"],
                   rec["close_moved"])
    close = [x for x, k in zip(d, c) if k]
    tick = [x for x, a, b in zip(d, m, lp) if a and not b]
    if not close or not tick:
        return None
    return sum(close) / len(close) - sum(tick) / len(tick)
