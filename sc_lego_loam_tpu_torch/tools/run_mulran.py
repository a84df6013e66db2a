"""Run the SLAM engine over a MulRan sequence.

    python -m sc_lego_loam_tpu_torch.tools.run_mulran --root DIR
        [--device cuda] [--scans N] [--no-loop] [--no-native]
        [--progress N] [--export PREFIX]

Prints one JSON line with scans/s, ATE, keyframes and loop count.  The
sequence directory must hold ``sensor_data/Ouster/<timestamp_ns>.bin`` scans
and, for the ATE, ``global_pose.csv``.  ``--device`` defaults to ``cuda`` and
fails without a card.
"""

from __future__ import annotations

import argparse
import json

from .. import runner
from ..utils import export


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="MulRan sequence dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=None, help="limit scans")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-native", action="store_true",
                    help="skip the native prefetching loader")
    ap.add_argument("--progress", type=int, default=20,
                    help="print progress every N scans (0 = quiet)")
    ap.add_argument("--export", default=None,
                    help="path prefix for trajectory/map export")
    args = ap.parse_args(argv)

    res = runner.run_mulran(
        args.root, limit=args.scans, use_native=not args.no_native,
        loop_enabled=not args.no_loop,
        progress_every=args.progress or None, device=args.device)

    if args.export:
        engine = res["engine"]
        export.save_trajectory_tum(args.export + "_traj.txt",
                                   res["times"], res["est"])
        export.save_ply(args.export + "_map.ply",
                        export.global_map_points(engine))
        export.save_checkpoint(args.export + "_ckpt.npz", engine)

    print(json.dumps({
        "sequence": res["sequence"],
        "device": str(res["engine"].device),
        "loader": res["loader"],
        "scans": res["scans"],
        "fps": round(res["fps"], 3),
        "keyframes": res["keyframes"],
        "loops_closed": res["loops_closed"],
        "ate_rmse_m": round(res["ate_rmse_m"], 4)
        if "ate_rmse_m" in res else None,
        "gt_length_m": round(res.get("gt_length_m", 0.0), 1) or None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
