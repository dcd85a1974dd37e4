"""The parallel paths of convopeq_tpu_torch (`parallel/`) on CPU gloo
processes, against the unsharded port and convopeq_tpu.

- The stream-sharded chain on 2 processes (each its contiguous slice of
  3 streams, the prepared state replicated, one gather) equals the
  unsharded chain bit for bit.
- The time-parallel NUC on 4 processes, a 12k-tap IR whose reach spans
  5 halo rounds of 4096-sample chunks, against JAX `nuc_convolve` in f64
  at 1e-9 of the peak (tests/test_parallel.py's bound).
- `parallel.dryrun.run_ranks` joins every child with a timeout, then
  kills it and fails (CHILD_TIMEOUT_S = 60 s).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models.nuc import FilterSpec as JSpec
from convopeq_tpu.models.nuc import nuc_convolve as j_nuc_convolve
from convopeq_tpu.models.nuc import nuc_prepare as j_nuc_prepare
from convopeq_tpu_torch.models.nuc import FilterSpec, nuc_prepare
from convopeq_tpu_torch.parallel import dryrun
from convopeq_tpu_torch.parallel.sharding import stream_slice
from convopeq_tpu_torch.parallel.time_parallel import spill_rounds

SR = 48000.0


def test_stream_slices_are_contiguous():
    for n in (1, 3, 7, 8):
        for world in (1, 2, 3, 4):
            got = [stream_slice(n, world, r) for r in range(world)]
            assert [i for s in got for i in range(n)[s]] == list(range(n))


def test_stream_sharded_chain_equals_unsharded():
    rng = np.random.default_rng(5)
    ir = rng.normal(size=6000) * np.exp(-np.arange(6000) / 1000.0)
    x = rng.normal(size=(3, 2, 2048)) * 0.25
    y = dryrun.run_ranks(2, "streams", {"ir": ir, "x": x},
                         timeout_s=dryrun.CHILD_TIMEOUT_S)
    fn, conv = dryrun.flagship(ir)
    y_ref = fn(torch.from_numpy(x), conv).numpy()
    assert np.isfinite(y).all()
    np.testing.assert_array_equal(y, y_ref)


def test_time_parallel_nuc_equals_jax():
    rng = np.random.default_rng(21)
    ir_len = 12_000
    ir = rng.normal(size=ir_len) * np.exp(-np.arange(ir_len) / 3000.0) * 0.2
    n = 4 * 4096
    x = rng.normal(size=(2, n)) * 0.3
    st = nuc_prepare(ir, 512, FilterSpec(SR), dtype=torch.float64,
                     device="cpu")
    assert spill_rounds(st, n // 4) == 5
    y = dryrun.run_ranks(4, "time", {"ir": ir, "x": x},
                         timeout_s=dryrun.CHILD_TIMEOUT_S)
    jst = j_nuc_prepare(jnp.asarray(ir), 512, JSpec(sample_rate=SR))
    y_ref = np.asarray(j_nuc_convolve(jnp.asarray(x), jst))
    assert y.shape == y_ref.shape
    assert np.abs(y - y_ref).max() <= 1e-9 * np.abs(y_ref).max()


def test_children_killed_at_the_timeout():
    """A child that cannot finish in time (the other rank never joins the
    group) is killed and the run fails."""
    x = np.zeros((2, 2, 512))
    with pytest.raises(RuntimeError, match="no exit in"):
        dryrun.run_ranks(2, "streams", {"ir": np.zeros(600), "x": x},
                         timeout_s=0.5)
