"""Multi-process dry run of the parallel paths on the CPU (counterpart of
__graft_entry__.py:277 `dryrun_multichip`).

`dryrun_multichip(n)` starts n CPU processes joined by a gloo process
group and checks, in f64, that
- the stream-parallel chain (parallel/sharding.py: each rank its slice of
  n streams through the flagship chain, the 20-band EQ and the 3-layer
  NUC of a 12k-tap IR, 2048 samples; one gather) equals the unsharded
  chain, and
- the time-parallel convolution (parallel/time_parallel.py: one stereo
  stream of n x 4096 samples, a 3.5k-tap IR, one halo round) equals the
  unsharded `nuc_convolve`,
each to 1e-9 of the output's peak (the JAX dry run's bound), printing the
measured differences.  There is one card, so this is a dry run of the
collectives, not a measurement.

The children import only the port and never touch CUDA (they run with
CUDA_VISIBLE_DEVICES empty and tensors on the CPU); the group is joined
through a file:// store in a temporary directory, so concurrent runs
cannot collide on a port.  Each child is joined with a timeout, then
killed, and the run fails.

    python -m convopeq_tpu_torch.parallel.dryrun [N]

`run_ranks(n, task, inputs)` is the launcher: it writes the inputs
(NumPy arrays) to the temporary directory, starts the n children on
`task` (a name in TASKS), and returns rank 0's output.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SR = 48000.0
BLOCK = 512
CHILD_TIMEOUT_S = 60.0


def flagship(ir, dtype=torch.float64):
    """(fn(x, conv), conv): the dry run's chain, __graft_entry__'s
    flagship (eq gains linspace(-6, 6, 20), the stereo NUC of `ir` at
    block 512, no soft clip), on the CPU."""
    from ..models.chain import ChainConfig, process_chain
    from ..models.convolver import stereo_prepare
    from ..models.eq import EQParams
    from ..models.nuc import FilterSpec
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-6.0, 6.0, 20)
    conv = stereo_prepare(np.asarray(ir, np.float64), BLOCK,
                          FilterSpec(sample_rate=SR), dtype=dtype,
                          device="cpu")
    cfg = ChainConfig(sample_rate=SR, soft_clip_enabled=False)

    def fn(x, conv_state):
        return process_chain(x, cfg, eqp, conv_state)
    return fn, conv


def _task_streams(inputs):
    from .sharding import sharded_chain
    fn, conv = flagship(inputs["ir"])
    return sharded_chain(fn)(torch.from_numpy(inputs["x"]), conv)


def _task_time(inputs):
    from ..models.nuc import FilterSpec, nuc_prepare
    from .time_parallel import time_parallel_nuc_convolve
    st = nuc_prepare(inputs["ir"], BLOCK, FilterSpec(sample_rate=SR),
                     dtype=torch.float64, device="cpu")
    return time_parallel_nuc_convolve(torch.from_numpy(inputs["x"]), st)


TASKS = {"streams": _task_streams, "time": _task_time}


def _child(task: str, rank: int, world: int, directory: str):
    import torch.distributed as dist
    d = Path(directory)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world)
    try:
        names = json.loads((d / "inputs.json").read_text())
        inputs = {k: np.load(d / f"{k}.npy") for k in names}
        y = TASKS[task](inputs)
        if rank == 0:
            np.save(d / "out.npy", y.numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, task: str, inputs: dict,
              timeout_s: float = CHILD_TIMEOUT_S) -> np.ndarray:
    """Run `task` on n gloo CPU processes with `inputs` ({name: array});
    returns rank 0's output.  Raises if a child fails or outlives
    `timeout_s` (every child is then killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for k, v in inputs.items():
            np.save(d / f"{k}.npy", np.asarray(v))
        (d / "inputs.json").write_text(json.dumps(sorted(inputs)))
        root = Path(__file__).resolve().parents[2]
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
               "PYTHONPATH": os.pathsep.join(
                   [str(root)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]),
               "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "convopeq_tpu_torch.parallel.dryrun",
             "--child", task, str(r), str(n), tmp],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
        deadline = time.monotonic() + timeout_s
        failed = []
        try:
            for r, p in enumerate(procs):
                try:
                    out, _ = p.communicate(
                        timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append(f"rank {r}: no exit in {timeout_s:g} s")
                    break
                if p.returncode != 0:
                    failed.append(f"rank {r}: exit {p.returncode}\n{out}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError(f"dry run '{task}' on {n} ranks failed: "
                               + "; ".join(failed))
        return np.load(d / "out.npy")


def dryrun_multichip(n_devices: int, log=print) -> dict:
    """The dry run on n gloo CPU processes (see the module note); returns
    {"streams": max diff / peak, "time": max diff / peak}."""
    from ..models.nuc import FilterSpec, nuc_convolve, nuc_prepare
    rng = np.random.default_rng(0)
    ir_len = 12_000
    ir = rng.normal(size=ir_len) * np.exp(-np.arange(ir_len)
                                          / (ir_len / 8.0))
    x = rng.normal(size=(n_devices, 2, 2048)) * 0.25
    t0 = time.perf_counter()
    y = run_ranks(n_devices, "streams", {"ir": ir, "x": x})
    fn, conv = flagship(ir)
    y_ref = fn(torch.from_numpy(x), conv).numpy()
    rel_s = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())

    rng = np.random.default_rng(7)
    ir_t = rng.normal(size=3500) * np.exp(-np.arange(3500) / 600.0)
    xt = rng.normal(size=(2, 4096 * n_devices)) * 0.25
    yt = run_ranks(n_devices, "time", {"ir": ir_t, "x": xt})
    st = nuc_prepare(ir_t, BLOCK, FilterSpec(sample_rate=SR),
                     dtype=torch.float64, device="cpu")
    yt_ref = nuc_convolve(torch.from_numpy(xt), st).numpy()
    rel_t = float(np.abs(yt - yt_ref).max() / np.abs(yt_ref).max())
    log(f"dry run on {n_devices} gloo CPU processes (f64): stream-parallel "
        f"chain vs unsharded max |diff| / peak {rel_s:.3e}, time-parallel "
        f"NUC vs unsharded {rel_t:.3e} (limit 1e-9), "
        f"{time.perf_counter() - t0:.1f} s")
    if not (y.shape == y_ref.shape and np.isfinite(y).all()
            and rel_s <= 1e-9):
        raise RuntimeError(f"stream-parallel chain != unsharded: {rel_s}")
    if not (yt.shape == yt_ref.shape and rel_t <= 1e-9):
        raise RuntimeError(f"time-parallel NUC != unsharded: {rel_t}")
    return {"streams": rel_s, "time": rel_t}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
