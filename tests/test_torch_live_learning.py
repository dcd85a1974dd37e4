"""Live learning in the port's engine on the CPU (`ConvoPeqEngine.
start_learning`, `stop_learning`, `_learning_loop`; the capture in
`process_streaming`), as tests/test_engine.py checks the JAX engine's.

The tests wait on a count of completed generations, not on a wall: a
stream keeps feeding the learner until it has published, with a hard
bound of LEARN_BOUND_S that fails the test.
"""
import time

import numpy as np
import pytest
import torch

from convopeq_tpu_torch.engine import ConvoPeqEngine
from convopeq_tpu_torch.models.dither import ADAPTIVE9
from convopeq_tpu_torch.models.learner import coefficient_bank_index

SR = 48000.0
BLOCK = 512
LEARN_BOUND_S = 120.0


def _engine():
    eng = ConvoPeqEngine(SR, BLOCK, dtype=torch.float64, device="cpu")
    eng.set_bypass(eq=True, conv=True)
    eng.set_dither(ADAPTIVE9, 16)
    return eng


def _music(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.01 * rng.normal(size=n)
    return np.stack([x, 0.8 * x])


def _published(eng):
    return any(e.category == "learning" for e in list(eng.telemetry.events))


@pytest.fixture(scope="module")
def learned():
    """Stream an ADAPTIVE9 engine with learning on, one learner window
    (8 blocks) at a time, each followed by a wait for the worker, until
    one generation is published; returns (engine, outputs, final
    state)."""
    eng = _engine()
    assert eng.start_learning(mode=0) is eng
    ring = eng._learn_ring
    assert eng.start_learning() is eng and eng._learn_ring is ring
    chunk = 8 * BLOCK                     # K_FFT_LENGTH samples
    x = torch.from_numpy(_music(chunk * 8))
    carry, outs, k = None, [], 0
    deadline = time.monotonic() + LEARN_BOUND_S
    try:
        while not _published(eng):
            assert time.monotonic() < deadline, \
                f"no generation published in {LEARN_BOUND_S:g} s"
            seg = x[:, (k % 8) * chunk:(k % 8 + 1) * chunk]
            y, carry = eng.process_streaming(seg, carry)
            outs.append(y)
            k += 1
            wait = time.monotonic() + 15.0
            while not _published(eng) and time.monotonic() < min(
                    wait, deadline):
                time.sleep(0.02)
    finally:
        st = eng.stop_learning(timeout=LEARN_BOUND_S)
    return eng, torch.cat(outs, dim=-1), st


def test_one_generation_published(learned):
    eng, _, st = learned
    assert st.generations >= 1 and np.isfinite(st.best_score)
    assert st.bank_index == coefficient_bank_index(SR, 16, 0)
    bank = eng.adaptive_banks.get(SR, 16, 0)
    assert bank is not None and bank.shape == (9,)
    np.testing.assert_array_equal(bank, st.best_coefficients)
    ev = [e for e in eng.telemetry.events if e.category == "learning"]
    assert ev and ev[0].detail["generation"] >= 1
    assert eng._learn_thread is None and eng._learn_ring is None
    assert eng.stop_learning().generations == st.generations


def test_preset_round_trip(learned):
    eng = learned[0]
    other = ConvoPeqEngine(SR, BLOCK, dtype=torch.float64, device="cpu")
    other.load_state(eng.save_state())
    assert other.learning_mode == 0
    assert other.adaptive_banks.to_dict() == eng.adaptive_banks.to_dict()
    assert other.save_state() == eng.save_state()


def test_adaptive9_output_on_the_16_bit_grid(learned):
    y = learned[1].numpy() * 32768.0
    assert np.isfinite(y).all() and np.abs(y).max() > 100
    np.testing.assert_array_equal(y, np.round(y))
