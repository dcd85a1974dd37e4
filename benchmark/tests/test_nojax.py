"""Nothing the benchmark loads is JAX or the JAX package: the top-level
name of every module (the part before the first dot) is compared whole,
so the port, whose name begins with the JAX package's, passes."""
import subprocess
import sys

from benchmark import harness


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "convopeq_tpu_torch_fake.sub", sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "convopeq_tpu.models", sys)
    assert "convopeq_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """Import every module a run imports, build a small system and run a
    tiny cell in a fresh interpreter; then look at sys.modules."""
    code = (
        "import sys, json\n"
        "from benchmark import harness, control, knee, run\n"
        "r = harness.run_cell('hall1m_48k.render', 5, 0.05, True, 'cpu',\n"
        "    config_override={'ir': {'taps': 5000, 'decay_divisor': 10.0,\n"
        "    'scale': 0.02}, 'render': {'fold': 'folded',\n"
        "    'partition': 2048}},\n"
        "    traffic_override={'batch': 1, 'seconds': 0.1})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
