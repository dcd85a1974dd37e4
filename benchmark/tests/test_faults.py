"""A run whose timed path is broken underneath comes out not correct:
the harness drives the whole run (the look for a card skipped) with the
program's call or step replaced by a faulty one, once for each fault the
cell can have: an answer altered where it is produced, half of the batch
left out, and, live, a step that returns its state unchanged."""
import pytest
import torch

from benchmark import harness
from benchmark.systems import folded

from .conftest import SMALL


def _alter(y):
    y = y.clone()
    y[..., 0, 0, y.shape[-1] // 2] += 0.25
    return y


def _half(y):
    y = y.clone()
    y[: max(1, y.shape[0] // 2)] = 0.0
    return y


@pytest.mark.parametrize("workload", ["hall1m_48k.render",
                                      "master384k_d24.render"])
@pytest.mark.parametrize("fault", [_alter, _half])
def test_render_fault_is_caught(monkeypatch, workload, fault):
    call = folded.Render.call

    def broken(self, x, u=None):
        out = call(self, x, u)
        if isinstance(out, tuple):
            return fault(out[0]), fault(out[1])
        return fault(out)
    monkeypatch.setattr(folded.Render, "call", broken)
    cfg, mix = SMALL[workload]
    r = harness.run_cell(workload, 2 ** 31 + 7, 0.01, False, "cpu",
                         config_override=cfg, traffic_override=mix)
    assert not r["correct"], r["checks"]


def test_quantizer_fault_is_caught(monkeypatch):
    """The dither's answer altered alone (the chain's output intact)."""
    call = folded.Render.call

    def broken(self, x, u=None):
        y, q = call(self, x, u)
        q = q.clone()
        q[..., 10] += 2.0 ** -23
        return y, q
    monkeypatch.setattr(folded.Render, "call", broken)
    cfg, mix = SMALL["master384k_d24.render"]
    r = harness.run_cell("master384k_d24.render", 2 ** 31 + 7, 0.01, False,
                         "cpu", config_override=cfg, traffic_override=mix)
    assert not r["correct"]
    assert r["checks"]["q_mismatch"]["value"] > 0


def _stale_step(self, state, block):
    """One step computed on a copy: the state comes back unchanged."""
    _, y = self.chain.step(state.clone(), block)
    return state, y


def _altered_step(self, state, block):
    state, y = self.chain.step(state, block)
    if state.step == 5:
        y = y.clone()
        y[..., 0, 3] += 0.25
    return state, y


def _half_step(self, state, block):
    state, y = self.chain.step(state, block)
    return state, _half(y)


@pytest.mark.parametrize("fault", [_stale_step, _altered_step, _half_step])
def test_live_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(folded.Live, "step", fault)
    cfg, mix = SMALL["hall1m_48k.live"]
    mix = {**mix, "check_streams": mix["streams"]}
    r = harness.run_cell("hall1m_48k.live", 2 ** 31 + 9, 0.3, False, "cpu",
                         config_override=cfg, traffic_override=mix)
    assert not r["correct"], r["checks"]


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    cfg, mix = SMALL["hall1m_48k.render"]
    r = harness.run_cell("hall1m_48k.render", 2 ** 31 + 13, 0.5, True,
                         "cuda", config_override=cfg, traffic_override=mix)
    assert r["correct"] and r["device"]["busy_s"] > 0
    torch.cuda.empty_cache()
