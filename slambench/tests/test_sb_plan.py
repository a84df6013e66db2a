"""The harness is driven by data: a new configuration, mix, per-layer
metric and cell are new files and new entries, planned by name with no
edit to a file the benchmark has."""

import hashlib
import json
import os

from slambench import plan, run
from sb_tiny import HERE, ROOT, add_cell, copy_tree


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        if "_cache" in d or "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_every_cell_plans():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = plan.load_cell(w["name"], os.path.join(ROOT,
                                                      "BENCHMARK.json"))
        assert cell.traffic["mode"] in ("replay", "latency")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}


def test_new_files_plan_and_run(tmp_path):
    before = _digests(HERE)
    dst = str(tmp_path)
    copy_tree(dst)
    # A new mix and a new metric reader, as files.
    mix = json.load(open(os.path.join(dst, "traffic", "fig8.replay.json")))
    mix.update(trajectory="cloverleaf", radius=32.0, petals=4,
               scans_per_lap=520)
    json.dump(mix, open(os.path.join(dst, "traffic", "petals.replay.json"),
                        "w"))
    with open(os.path.join(dst, "metrics", "scans_traced.py"), "w") as f:
        f.write('"""scans_traced (scans): scans in the traced stretch."""\n'
                "\n\ndef read(rec):\n    return len(rec['device_ms'])\n")
    b = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    b["per_layer"].append({"name": "scans_traced", "unit": "scans",
                           "better": "higher", "source": "program_span",
                           "layer": "launch", "moves": "scans_per_s",
                           "workloads": []})
    json.dump(b, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    cell = add_cell(dst, "throwaway", traffic="petals.replay",
                    metrics=("scans_traced",))
    assert cell.traffic["trajectory"] == "cloverleaf"
    assert set(cell.readers) == {"scans_traced"}
    assert cell.readers["scans_traced"]({"device_ms": [1.0, 2.0]}) == 2
    assert [m["name"] for m in cell.end_to_end] == ["scans_per_s",
                                                    "setup_s"]
    out = run.run_cell(cell, 2 ** 31 + 11, 3600.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"scans_per_s", "setup_s"}
    assert out["attempted"] == 14 - cell.config["warmup_scans"]
    assert list(out)[-1] == "checks"
    assert _digests(HERE) == before
