"""The MAC probe's step counts and the readers of the CUDA toolchain's
output it shares with the quantizer probe (convopeq_tpu_torch/sweep.py),
on the CPU.  The probe itself (csrc/mac_probe.cu) runs only on the card:
`python -m convopeq_tpu_torch.sweep probe mac`."""
import pytest

from convopeq_tpu_torch import sweep


@pytest.mark.parametrize("K,P", [(88, 33), (704, 64), (5, 12), (9, 1)])
def test_mac_step_counts(K, P):
    """mac_steps: the terms of one bin's sums over K frames; mac_tile_steps:
    the j-steps of a warp of the 8-frame MAC, j = 0 .. min(P-1, f0+7)."""
    assert sweep.mac_steps(K, P) == sum(
        1 for f in range(K) for j in range(P) if j <= f)
    tiles = range(0, K, 8)
    assert sweep.mac_tile_steps(K, P) == sum(
        len([j for j in range(P) if j <= f0 + 7]) for f0 in tiles)
    # each step of a tile serves 8 outputs: at least every term is covered
    assert 8 * sweep.mac_tile_steps(K, P) >= sweep.mac_steps(K, P)


def test_short_names_bool_template_arguments(monkeypatch):
    class Done:
        stdout = ("void (anonymous namespace)::mac_probe_ring_kernel<float2, "
                  "(bool)1>(float2 const*, float2 const*, float2*, int, int, "
                  "int, int, long long*)\n")
    monkeypatch.setattr(sweep.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.setattr(sweep, "_tool", lambda name: name)
    assert sweep._short("_Zmangled") == "mac_probe_ring_kernel<float2, true>"


def test_mac_shapes_are_the_paths():
    """The probe's shapes: the A/B shape of the frame kernels and L1 of the
    prefilter chain, both of which `sweep ab` also runs."""
    (_, C, K, p, P), (_, C1, K1, p1, P1) = sweep.MAC_SHAPES
    assert (C, K, p, P) == (8, 88, 32768, 33)
    assert (C1, K1, p1, P1) == sweep.AB_MAC_L1
    assert {33, 64} <= set(sweep.MAC_PARTS)
