"""A later cell, configuration, system and per-layer metric come from new
files alone: a copy of BENCHMARK.json gains workloads over new traffic
files, a configuration naming a new system module, and a per-layer
metric with its own reader file; the harness runs the new cells and
reports the new metric without an edit to any file it had.  A
configuration that names no system, and a cell whose system does not
serve its traffic kind, are refused."""
import json
import shutil

import pytest

from benchmark import harness

from .conftest import IR_SMALL, SMALL

READER = '''"""Calls traced in the render segment (a test's metric)."""


def read(ctx):
    return ctx.get("traced_calls")
'''

# the folded system's programs under another name, with a check of its
# own: the largest absolute error of a stream over its largest reference
# sample
WRAPPED = '''"""A test's system: the folded programs, its own check."""
import torch

from benchmark.reference import chain as R
from benchmark.systems import folded

render = folded.Render
live = folded.Live
launch_counts = folded.launch_counts


def _peak_err(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def check_render(cfg, ir, inputs, outputs, seed):
    h = folded.folded_response(cfg, ir, inputs[0][0].device, False)
    sr = float(cfg["sample_rate"])
    return {"peak_err": max(
        _peak_err(y.double(), R.run_chain(x.double(), h, cfg["chain"], sr))
        for (x, _), y in zip(inputs, outputs))}


def check_live(cfg, ir, feed, keep, kept, n_window, dev):
    h = folded.folded_response(cfg, ir, dev, False)
    sr = float(cfg["sample_rate"])
    worst = 0.0
    for i, s in enumerate(keep):
        x = torch.as_tensor(feed.stream_input(int(s), n_window),
                            device=dev).double()
        ref = R.run_chain(x[None], h, cfg["chain"], sr)[0]
        worst = max(worst, _peak_err(torch.as_tensor(kept[i]).double(), ref))
    return {"peak_err": worst}
'''

RENDER_ONLY = '''"""A test's system that serves only offline render."""
from benchmark.systems import folded

render = folded.Render
check_render = folded.check_render
launch_counts = folded.launch_counts
'''


def _copied_root(tmp_path):
    """A root with copies of BENCHMARK.json and the benchmark's data,
    readers and systems, and the bytes of every file copied."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "metrics", "systems"):
        shutil.copytree(harness.ROOT / "benchmark" / d,
                        tmp_path / "benchmark" / d)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}
    return tmp_path, before


def _unchanged(root, before):
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert (root / rel).read_bytes() == data, rel


def _write(root, rel, text):
    (root / rel).write_text(text)


def _add_config(root, spec, name, system):
    cfg = harness.load_json(harness.ROOT / "benchmark" / "configs"
                            / "hall1m_48k.json")
    cfg["name"] = name
    if system is None:
        del cfg["system"]
    else:
        cfg["system"] = system
    cfg["limits"] = {"render": {"peak_err": 1e-4},
                     "live": {"peak_err": 1e-4}}
    _write(root, f"benchmark/configs/{name}.json", json.dumps(cfg))
    spec["configs"].append({"name": name, "source": "a test",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "a test's configuration"})


def _add_cell(spec, name, config, traffic, e2e):
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "a test's cell"})
    next(m for m in spec["end_to_end"]
         if m["name"] == e2e)["workloads"].append(name)


def test_new_cell_and_metric_from_new_files(tmp_path):
    root, before = _copied_root(tmp_path)
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
    _unchanged(root, before)


def test_new_system_from_new_files(tmp_path):
    """A system that exists only as a new module, with its own check,
    runs a render cell (traced too) and a live cell."""
    root, before = _copied_root(tmp_path)
    _write(root, "benchmark/systems/wrapped.py", WRAPPED)
    _write(root, "benchmark/traffic/render_wrapped.json", json.dumps(
        {"kind": "render", "batch": 1, "seconds": 0.2, "batches": 2,
         "amplitude": 0.1}))
    _write(root, "benchmark/traffic/live_wrapped.json", json.dumps(
        {"kind": "live", "streams": 3, "pool_blocks": 8, "amplitude": 0.25,
         "check_streams": 2, "late_factor": 1.5, "trace_blocks": 8}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    _add_config(root, spec, "hall_wrapped", "wrapped")
    _add_cell(spec, "hall_wrapped.render", "hall_wrapped", "render_wrapped",
              "rtf")
    _add_cell(spec, "hall_wrapped.live", "hall_wrapped", "live_wrapped",
              "block_p99_ms")
    next(m for m in spec["per_layer"] if m["name"] ==
         "setup.fold_s")["workloads"].append("hall_wrapped.render")
    _write(root, "BENCHMARK.json", json.dumps(spec))
    small = {"ir": IR_SMALL["hall1m_48k"]}
    runs = [("hall_wrapped.render", 0.05, False,
             {**small, "render": {"fold": "folded", "partition": 4096}}),
            ("hall_wrapped.render", 0.05, True,
             {**small, "render": {"fold": "folded", "partition": 4096}}),
            ("hall_wrapped.live", 0.2, False, small)]
    for cell, seconds, trace, cfg in runs:
        ctx = {}
        r = harness.run_cell(cell, 2 ** 31 + 17, seconds, trace, "cpu",
                             root=root, config_override=cfg, ctx_out=ctx)
        assert r["correct"], (cell, r["checks"])
        assert set(r["checks"]) == {"peak_err"}
        if not trace:
            assert "setup_s" in r["metrics"], cell
        else:
            assert r["metrics"]["setup.fold_s"]["value"] > 0
            # the launches counted by the new system's own counters
            assert "soft_clip_local2x" in ctx["launches"]
    _unchanged(root, before)


def test_a_configuration_without_a_system_is_refused(tmp_path):
    root, _ = _copied_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    _add_config(root, spec, "hall_nosys", None)
    _add_cell(spec, "hall_nosys.render", "hall_nosys", "render_64x60s", "rtf")
    _write(root, "BENCHMARK.json", json.dumps(spec))
    with pytest.raises(ValueError, match="hall_nosys.json"):
        harness.cell_data("hall_nosys.render", root)
    with pytest.raises(ValueError, match="hall_nosys.json"):
        harness.run_cell("hall_nosys.render", 1, 0.01, False, "cpu",
                         root=root)


def test_a_kind_the_system_does_not_serve_is_refused(tmp_path):
    root, _ = _copied_root(tmp_path)
    _write(root, "benchmark/systems/render_only.py", RENDER_ONLY)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    _add_config(root, spec, "hall_render_only", "render_only")
    _add_cell(spec, "hall_render_only.live", "hall_render_only", "live_32",
              "block_p99_ms")
    _write(root, "BENCHMARK.json", json.dumps(spec))
    with pytest.raises(ValueError, match="'render_only'.*'live'"):
        harness.run_cell("hall_render_only.live", 1, 0.01, False, "cpu",
                         root=root)
