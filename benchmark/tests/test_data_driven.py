"""A later cell and a later per-layer metric come from new files alone:
a copy of BENCHMARK.json gains a workload over a new traffic file and a
per-layer metric with its own reader file; the harness runs the new cell
and reports the new metric without an edit to any file it had."""
import json
import shutil

from benchmark import harness

from .conftest import SMALL

READER = '''"""Calls traced in the render segment (a test's metric)."""


def read(ctx):
    return ctx.get("traced_calls")
'''


def test_new_cell_and_metric_from_new_files(tmp_path):
    root = tmp_path
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.ROOT / "benchmark" / d,
                        root / "benchmark" / d)
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    (root / "benchmark" / "traffic" / "render_tiny.json").write_text(
        json.dumps({"kind": "render", "batch": 1, "seconds": 0.2,
                    "batches": 2, "amplitude": 0.1}))
    (root / "benchmark" / "metrics" / "chain.calls_traced.py").write_text(
        READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "hall1m_48k.tiny", "config":
                              "hall1m_48k", "traffic": "render_tiny",
                              "chips": 1, "why": "a test's cell"})
    spec["end_to_end"][0]["workloads"].append("hall1m_48k.tiny")
    spec["per_layer"].append({"name": "chain.calls_traced", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "chain", "moves": "rtf",
                              "workloads": ["hall1m_48k.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg, _ = SMALL["hall1m_48k.render"]
    for trace in (False, True):
        r = harness.run_cell("hall1m_48k.tiny", 7, 0.05, trace, "cpu",
                             root=root, config_override=cfg)
        assert r["correct"], r["checks"]
        if trace:
            assert r["metrics"]["chain.calls_traced"]["value"] >= 2
        else:
            assert set(r["metrics"]) == {"rtf", "peak_gib", "setup_s"}
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert (root / rel).read_bytes() == data
