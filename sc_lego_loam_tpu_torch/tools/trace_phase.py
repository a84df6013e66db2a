"""One ``--trace 1`` run of a ``slambench`` cell that also writes its
program phase's record (``rec["program"]``: the tracer's drained spans,
records and per-scan view, ``slambench/program.phase``) to a JSON
file, for the per-scan tables and idle gaps read from it.

    python -m sc_lego_loam_tpu_torch.tools.trace_phase CELL SEED OUT.json

Run from the root of a checkout (``slambench`` is imported from there).
"""

import json
import os
import sys


def main(cell: str, seed: int, out: str) -> int:
    sys.path.insert(0, os.getcwd())
    from slambench import program, run

    phase = program.phase

    def keep(*args, **kw):
        kept = phase(*args, **kw)
        with open(out, "w") as f:
            json.dump(kept, f)
        return kept

    program.phase = keep
    return run.main(["--workload", cell, "--seed", str(seed),
                     "--seconds", "30", "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
