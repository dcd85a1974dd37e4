"""Shared sizes for the benchmark's CPU tests: every cell cut to a size
the plain (CPU) versions of the port's kernels run in seconds."""
import pytest
import torch

IR_SMALL = {"hall1m_48k": {"taps": 20000, "decay_divisor": 10.0,
                           "scale": 0.02},
            "master384k_d24": {"taps": 20000, "decay_divisor": 6.0,
                               "scale": 0.02}}
SMALL = {
    "hall1m_48k.render": (
        {"ir": IR_SMALL["hall1m_48k"],
         "render": {"fold": "folded", "partition": 4096}},
        {"batch": 2, "seconds": 0.5}),
    "master384k_d24.render": (
        {"ir": IR_SMALL["master384k_d24"],
         "render": {"fold": "semi_folded", "partition": 4096}},
        {"batch": 1, "seconds": 0.012}),
    "hall1m_48k.live": ({"ir": IR_SMALL["hall1m_48k"]},
                        {"streams": 4, "check_streams": 2,
                         "trace_blocks": 8}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test unless torch sees a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda")
