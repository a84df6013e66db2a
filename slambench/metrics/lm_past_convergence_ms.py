"""lm_past_convergence_ms (ms): per scan, the device ms of the odometry
LM's iterations run after it converged: from the end of the iteration at
which ``done`` first held to the end of its last iteration (0 where it
never converged), from the program's own trace (``rec["program"]``: one
record at each LM iteration's end); the mean over the phase's scans."""


def read(rec):
    p = rec.get("program")
    past = []
    for s in (p or {}).get("scans", []):
        lm = s.get("lm")
        if not lm:
            continue
        first = next((t for t, done in lm if done), None)
        past.append(0.0 if first is None else (lm[-1][0] - first) * 1e-6)
    return sum(past) / len(past) if past else None
