"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the port (`convopeq_tpu_torch`)
on a machine with an NVIDIA card.  Earlier lines (standard error) give
the card's name and power limit and, in a live cell, how late the
generator ran; the last lines of standard error give each number the
correctness check compared beside its limit, and the last line of
standard output is the result as one JSON object.  Without a card, or
with fewer cards than the cell asks for, it exits 2 and prints no
result; it exits 3 if JAX or the JAX package was loaded.

Every cache the program builds stays inside the checkout: the port
builds its CUDA libraries into `convopeq_tpu_torch/_build/`, and the
run points TRITON_CACHE_DIR at `benchmark/_cache/triton` in case
anything compiles a Triton kernel.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()


def _since_process_start() -> float:
    """Seconds from this process's start to now, from /proc (10 ms
    resolution); 0 where /proc has no such record."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


_PRE = _since_process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(s: str) -> None:
    print(s, file=sys.stderr, flush=True)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch
        return torch.cuda.get_device_name(0) + ", power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "benchmark" / "_cache" / "triton"))
    os.environ["USE_FLAX"] = "0"
    import torch
    from benchmark import harness
    spec = harness.load_spec(ROOT)
    w, _ = harness.cell(spec, a.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < int(w["chips"]):
        _log(f"needs {w['chips']} CUDA device(s); torch sees {seen}")
        return 2
    _log(f"card: {_card()}")
    result = harness.run_cell(
        a.workload, a.seed, a.seconds, bool(a.trace), "cuda", ROOT,
        t_setup0=lambda t: _PRE + (t - _T0), log=_log)
    bad = harness.forbidden_modules()
    if bad:
        _log(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    for k, c in result["checks"].items():
        _log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
