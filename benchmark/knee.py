"""The sweep that finds a live cell's knee: the most streams at which the
open loop keeps its p99 block latency within one block period and its
backlog from growing.

    python3 -m benchmark.knee --workload hall1m_48k.live \
        --streams 256 512 1024 --seconds 20 --seed <n>

prints one JSON line a stream count (p99 and median latency, the share
of blocks later than 1.5 periods, the host's median step time, peak
device memory, and whether the latency grew from the window's first
tenth to its last), and stops after the first count whose p99 passes
the period or that does not fit the card.  The benchmark's own runs
never sweep: a live cell's stream count is fixed in its traffic file.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    for n in a.streams:
        ctx = {}
        try:
            r = harness.run_cell(a.workload, a.seed, a.seconds, False,
                                 traffic_override={"streams": n},
                                 ctx_out=ctx)
        except torch.OutOfMemoryError as e:
            print(json.dumps({"streams": n, "out_of_memory": str(e)[:200]}))
            break
        lat = ctx["latency_ms"]
        tenth = max(1, len(lat) // 10)
        row = {"streams": n, "p99_ms": float(np.percentile(lat, 99)),
               "median_ms": float(np.median(lat)),
               "p90_ms": float(np.percentile(lat, 90)),
               "p95_ms": float(np.percentile(lat, 95)),
               "max_ms": float(lat.max()),
               "fire_ms": {str(r): [float(np.percentile(lat[r - 1::r], q))
                                    for q in (10, 50, 90)]
                           for _, _, r in ctx["live"]["layers"] if r > 1},
               "late_pct": 100.0 * float(np.mean(
                   lat > ctx["late_factor"] * ctx["period_ms"])),
               "first_tenth_median_ms": float(np.median(lat[:tenth])),
               "last_tenth_median_ms": float(np.median(lat[-tenth:])),
               "host_ms": float(np.median(ctx["host_ms"])),
               "peak_gib": r["metrics"]["peak_gib"]["value"],
               "correct": r["correct"], "checks": r["checks"]}
        print(json.dumps(row), flush=True)
        del ctx, r
        torch.cuda.empty_cache()
        if row["p99_ms"] > period_ms(a.workload):
            break
    return 0


def period_ms(workload: str) -> float:
    """The block period of a live cell's configuration, in ms."""
    cfg = harness.cell_data(workload)[1]
    return 1e3 * int(cfg["block_size"]) / float(cfg["sample_rate"])


if __name__ == "__main__":
    sys.exit(main())
