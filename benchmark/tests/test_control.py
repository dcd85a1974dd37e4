"""The control comes out not correct, at a size a test run holds: the
reference put in the program's place in bfloat16 (offline), and the
program's float16 delay line (live), both judged by the benchmark's own
comparison and limits, while the program itself passes on the same
seed."""
import pytest

from benchmark import control, harness

from .conftest import SMALL


@pytest.mark.parametrize("workload", ["hall1m_48k.render",
                                      "master384k_d24.render"])
def test_render_control_fails(workload):
    cfg, mix = SMALL[workload]
    limits = harness.load_json(harness.ROOT / "benchmark" / "configs" / (
        workload.split(".")[0] + ".json"))["limits"]["render"]
    nums = control.control_render(workload, 2 ** 31 + 3, "cpu", cfg, mix)
    assert nums["rel_rms"] > 30 * limits["rel_rms"]
    program = harness.run_cell(workload, 2 ** 31 + 3, 0.01, False, "cpu",
                               config_override=cfg, traffic_override=mix)
    assert program["correct"], program["checks"]


def test_live_control_fails():
    cfg, mix = SMALL["hall1m_48k.live"]
    args = ("hall1m_48k.live", 2 ** 31 + 5, 0.2, False, "cpu")
    ctl = harness.run_cell(*args, config_override=cfg, traffic_override=mix,
                           fdl_dtype="float16")
    assert not ctl["correct"]
    assert ctl["checks"]["rel_rms"]["value"] > 10 * \
        ctl["checks"]["rel_rms"]["limit"]
    program = harness.run_cell(*args, config_override=cfg,
                               traffic_override=mix)
    assert program["correct"], program["checks"]
