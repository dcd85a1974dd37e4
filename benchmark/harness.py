"""One run of one cell, driven by data: BENCHMARK.json names the cell's
configuration file and traffic mix; the configuration
(`benchmark/configs/<name>.json`) names its system under test by its
"system" key and gives that system's sizes, the mix
(`benchmark/traffic/<traffic>.json`) the load, the system is the module
`benchmark/systems/<system>.py` (its program, the check of its outputs
and its kernels' launch counters; see benchmark/systems/__init__.py),
and each per-layer metric is the function `read(ctx)` of
`benchmark/metrics/<name>.py`, which returns its number or None when
the run gave it nothing to read.

A later cell, configuration, system, mix or metric is a new file and a
new entry in BENCHMARK.json: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from . import roofline, system, traffic

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "convopeq_tpu")
# what a system module gives for each traffic kind it serves
KIND_FUNCTIONS = {"render": ("render", "check_render"),
                  "live": ("live", "check_live")}


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str):
    """(workload entry, configuration entry) of a cell."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w, next(c for c in spec["configs"]
                           if c["name"] == w["config"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(path: Path) -> dict:
    """A configuration file; one that names no system is refused."""
    cfg = load_json(path)
    if "system" not in cfg:
        raise ValueError(f"configuration {path.name} names no system: it "
                         f"needs a \"system\" key, the name of a module "
                         f"under benchmark/systems/")
    return cfg


def cell_data(workload: str, root: Path = ROOT):
    """(workload entry, configuration, traffic mix) of a cell, from the
    files BENCHMARK.json names."""
    w, centry = cell(load_spec(root), workload)
    mix = root / "benchmark" / "traffic" / f"{w['traffic']}.json"
    return w, load_config(root / centry["file"]), load_json(mix)


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: end to end with
    trace off, per layer with it on."""
    e2e = {m["name"]: m for m in spec["end_to_end"]}

    def applies(m, names):
        if "workloads" in m:
            return workload in m["workloads"]
        return names is None or applies(e2e[m["moves"]], None)
    if not trace:
        return [m for m in spec["end_to_end"] if applies(m, None)]
    return [m for m in spec["per_layer"] if applies(m, True)]


def reader(name: str, root: Path = ROOT):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_module(name: str, root: Path = ROOT):
    """The module benchmark/systems/<name>.py under `root`: imported as
    `benchmark.systems.<name>` when it is this package's own, else loaded
    from its file, as a metric's reader is."""
    path = (root / "benchmark" / "systems" / f"{name}.py").resolve()
    if not path.is_file():
        raise ValueError(f"no system {name!r}: {path} does not exist")
    if path == Path(__file__).resolve().parent / "systems" / f"{name}.py":
        return importlib.import_module(f"benchmark.systems.{name}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_system_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_for(cfg: dict, kind: str, root: Path = ROOT):
    """The configuration's system module, refused unless it serves the
    traffic kind."""
    if kind not in KIND_FUNCTIONS:
        raise ValueError(f"traffic kind {kind!r}")
    mod = system_module(cfg["system"], root)
    missing = [f for f in KIND_FUNCTIONS[kind] + ("launch_counts",)
               if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"system {cfg['system']!r} does not serve traffic "
                         f"kind {kind!r}: it lacks {', '.join(missing)}")
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _limits_judge(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit; a number with no
    limit set yet, or one not finite, is not correct."""
    checks, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        ok = ok and lim is not None and math.isfinite(v) and v <= lim
    return ok, checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, t_setup0=None,
             config_override=None, traffic_override=None, fdl_dtype=None,
             ctx_out=None, log=lambda s: print(s, file=sys.stderr)) -> dict:
    """Run `workload` once and return its result line as a dict.
    config_override / traffic_override update the files' values (the
    tests' small sizes, the knee sweep's stream counts); fdl_dtype runs a
    live cell on the program's lower-precision delay line (its control);
    ctx_out, a dict, receives what the per-layer readers read;
    t_setup0(t) gives seconds from process start to the time t of the
    first timed call."""
    spec = load_spec(root)
    _, cfg, mix = cell_data(workload, root)
    cfg.update(config_override or {})
    mix.update(traffic_override or {})
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_setup0 = t_setup0 or (lambda t: 0.0)
    sysmod = system_for(cfg, mix["kind"], root)
    ir = system.ir_from_seed(cfg, seed)
    item = 8 if cfg["dtype"] == "float64" else 4
    ctx = {"kind": mix["kind"], "config": cfg, "traffic": mix, "item": item,
           "trace": None}
    if mix["kind"] == "render":
        res, numbers, attempted, failed = _render(sysmod, cfg, mix, ir, seed,
                                                  seconds, trace, dev,
                                                  t_setup0, ctx)
    else:
        res, numbers, attempted, failed = _live(sysmod, cfg, mix, ir, seed,
                                                seconds, trace, dev, t_setup0,
                                                ctx, log, fdl_dtype)
    correct, checks = _limits_judge(numbers, cfg["limits"][mix["kind"]])
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        v = (res.get(m["name"]) if not trace
             else reader(m["name"], root)(ctx))
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": res["peak_bytes"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": devinfo}
    if trace:
        t = ctx["trace"]
        devinfo["busy_s"] = t.busy_s
        devinfo["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.idle_gaps()}
    out["checks"] = checks
    if ctx_out is not None:
        ctx_out.update(ctx)
    return out


def _render(sysmod, cfg, mix, ir, seed, seconds, trace, dev, t_setup0,
            ctx):
    sysm = sysmod.render(cfg, ir, dev)
    inputs = traffic.render_inputs(mix, cfg, seed, dev,
                                   cfg.get("dither") is not None)
    r = traffic.run_render(sysm, inputs, seconds, trace, t_setup0,
                           sysmod.launch_counts)
    n = inputs[0][0].shape[-1]
    B = inputs[0][0].shape[0]
    ctx.update({"calls": r["calls"], "wall_s": r["wall_s"],
                "render": sysm.shapes(inputs)})
    if r["segment"] is not None:
        ctx["trace"] = r["segment"]["trace"]
        ctx["traced_calls"] = r["segment"]["calls"]
        ctx["launches"] = r["segment"]["launches"]
    del sysm
    outputs = r.pop("outputs")
    res = {"rtf": r["calls"] * B * n / float(cfg["sample_rate"])
           / r["wall_s"],
           "peak_gib": r["peak_bytes"] / 2 ** 30, "setup_s": r["setup_s"],
           "peak_bytes": r["peak_bytes"]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    failed = sum(0 if all(bool(torch.isfinite(t).all()) for t in
                          (y if isinstance(y, tuple) else (y,))) else 1
                 for y in outputs)
    numbers = sysmod.check_render(cfg, ir, inputs, outputs, seed)
    return res, numbers, r["calls"], failed


def _live(sysmod, cfg, mix, ir, seed, seconds, trace, dev, t_setup0, ctx,
          log, fdl_dtype=None):
    sysm = sysmod.live(cfg, ir, dev, fdl_dtype)
    block = sysm.block_size
    period = block / float(cfg["sample_rate"])
    n_window = max(1, int(round(seconds / period)))
    n_trace = int(mix["trace_blocks"]) if trace else 0
    warm = max(r for _, _, r in sysm.layers)
    feed = traffic.LiveFeed(mix, cfg, seed, dev,
                            max(warm, n_window + n_trace), block)
    rng = np.random.default_rng([int(seed), 2])
    streams = int(mix["streams"])
    keep = np.sort(rng.choice(streams, size=min(int(mix["check_streams"]),
                                                streams), replace=False))
    r = traffic.run_live(sysm, feed, mix, n_window, period, trace, keep,
                         t_setup0, warm, n_trace, dev, sysmod.launch_counts)
    late = np.asarray(r["generator_late_s"]) * 1e3
    if late.size:
        log(f"generator: {late.size} of {n_window} blocks started on time, "
            f"late by median {np.median(late):.4f} ms, p99 "
            f"{np.percentile(late, 99):.4f} ms, max {late.max():.4f} ms")
    lat_ms = r["latency_s"] * 1e3
    ctx.update({"steps": n_window, "latency_ms": lat_ms,
                "host_ms": r["host_s"] * 1e3, "period_ms": period * 1e3,
                "late_factor": float(mix["late_factor"]),
                "live": {"C": 2 * streams, "layers": sysm.layers}})
    if r["segment"] is not None:
        ctx["trace"] = r["segment"]["trace"]
        ctx["traced_steps"] = r["segment"]["steps"]
        ctx["first_step"] = r["segment"]["first_step"]
        ctx["launches"] = r["segment"]["launches"]
    del sysm
    res = {"block_p99_ms": float(np.percentile(
        np.where(np.isfinite(lat_ms), lat_ms, 1e6), 99)),
           "peak_gib": r["peak_bytes"] / 2 ** 30, "setup_s": r["setup_s"],
           "peak_bytes": r["peak_bytes"]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = sysmod.check_live(cfg, ir, feed, keep, r["kept"], n_window,
                                dev)
    return res, numbers, n_window, r["failed"]


def roofline_sum(ctx, families, launches_of):
    """(least seconds, device seconds) over the traced segment's launches
    of the kernel `families`; None when the trace has none of them or the
    launch counters disagree with the launches the shapes predict."""
    t = ctx.get("trace")
    if t is None:
        return None
    match = (lambda n: any(roofline.is_kernel(n, f) for f in families))
    dev_s = t.device_time_s(match)
    got = ctx.get("launches", {})
    least, want = launches_of(ctx)
    if dev_s <= 0.0 or any(got.get(k, 0) != v for k, v in want.items()):
        return None
    return least, dev_s
