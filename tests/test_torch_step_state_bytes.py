"""The serving step's "step" span counts the state it carries: under
torch.profiler every "step" span's `state_bytes` is the step's streams x
`StreamingChain.state_bytes()`, which equals the bytes `init_state`
allocates a stream, for an f32 chain, an f64 chain (complex128 delay
line) and an f32 chain with the f16 delay line; and the step's output
and state are bit for bit the same traced and untraced."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models.nuc import FilterSpec
from convopeq_tpu_torch.runtime import telemetry as tel
from convopeq_tpu_torch.runtime.streaming import StreamingChain

SR = 48000.0
BLOCK = 64
BLOCKS = 10
TIERS = {"f32": (torch.float32, None), "f64": (torch.float64, None),
         "f32_f16_fdl": (torch.float32, torch.float16)}


@pytest.fixture(scope="module", params=sorted(TIERS))
def chain(request):
    """A folded three-layer StreamingChain of the tier and 3 streams of
    BLOCKS blocks of input."""
    dtype, fdl = TIERS[request.param]
    rng = np.random.default_rng(29)
    ir = rng.normal(size=(2, 20_000)) * np.exp(
        -np.arange(20_000) / 4000.0) * 0.05
    sc = StreamingChain.folded_from_ir(
        t_chain.ChainConfig(sample_rate=SR), None, ir, FilterSpec(SR),
        block_size=BLOCK, dtype=dtype, fdl_dtype=fdl, device="cpu")
    x = torch.from_numpy(np.clip(rng.normal(size=(3, 2, BLOCKS * BLOCK))
                                 * 0.3, -1.0, 1.0)).to(dtype)
    return sc, x


def _run(sc, x):
    st = sc.init_state((x.shape[0],))
    ys = []
    for k in range(BLOCKS):
        st, y = sc.step(st, x[..., k * BLOCK:(k + 1) * BLOCK])
        ys.append(y.clone())
    return torch.cat(ys, -1), st


def test_state_bytes_is_what_init_state_allocates(chain):
    sc, _ = chain
    assert sc.state_bytes() == sc.init_state((1,)).nbytes()
    assert sc.init_state((5,)).nbytes() == 5 * sc.state_bytes()


def test_step_span_counts_the_streams_state(chain):
    sc, x = chain
    n0 = len(tel.SPANS.records)
    with profile(activities=[ProfilerActivity.CPU]):
        _run(sc, x)
    steps = [r for r in tel.spans()[-(len(tel.SPANS.records) - n0):]
             if r.name == "step"]
    assert len(steps) == BLOCKS
    for k, r in enumerate(steps):
        assert r.counts == {"streams": 3, "step": k,
                            "state_bytes": 3 * sc.state_bytes()}


def test_step_bit_identical_traced_and_untraced(chain):
    sc, x = chain
    y_off, st_off = _run(sc, x)
    with profile(activities=[ProfilerActivity.CPU]):
        y_on, st_on = _run(sc, x)
    assert torch.equal(y_on, y_off)
    for a, b in zip(st_on.tensors(), st_off.tensors()):
        assert torch.equal(a, b)
