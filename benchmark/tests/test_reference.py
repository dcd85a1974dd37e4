"""The plain reference against the port at a tiny size on the CPU, in
f64: the fold (folded and semi-folded), the soft clip, the DC blocker,
the streaming chain's output and the quantizer, bit for bit where the
arithmetic is the same."""
import copy
import json

import numpy as np
import pytest
import torch

from benchmark import harness, system
from benchmark.systems import folded
from benchmark.reference import chain as R
from benchmark.reference import coeffs as C
from benchmark.reference.quantizer import lattice_quantize

from .conftest import IR_SMALL


def _cfg(name, **over):
    cfg = json.load(open(harness.ROOT / "benchmark" / "configs"
                         / f"{name}.json"))
    cfg = copy.deepcopy(cfg)
    cfg["ir"] = IR_SMALL[name]
    cfg["dtype"] = "float64"
    cfg.update(over)
    return cfg


def _h(cfg, ir, semi):
    sr = cfg["sample_rate"]
    return torch.as_tensor(R.folded_ir(
        ir, cfg["block_size"], sr, C.eq_params(cfg["eq_gains_db"]),
        {"sample_rate": sr}, cfg["chain"], 1 if semi else 2))


@pytest.mark.parametrize("name", ["hall1m_48k", "master384k_d24"])
def test_render_chain_matches_port(name):
    cfg = _cfg(name, render={"fold": _cfg(name)["render"]["fold"],
                             "partition": 4096})
    ir = system.ir_from_seed(cfg, 2 ** 31 + 11)
    s = folded.Render(cfg, ir, "cpu")
    s.dither = None
    x = torch.randn((2, 2, 30000), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64) * 0.25
    semi = cfg["chain"]["soft_clip_enabled"]
    ref = R.run_chain(x, _h(cfg, ir, semi), cfg["chain"], cfg["sample_rate"])
    assert float((s.call(x) - ref).norm() / ref.norm()) < 1e-12


def test_streaming_chain_matches_reference_from_the_first_block():
    cfg = _cfg("hall1m_48k")
    ir = system.ir_from_seed(cfg, 17)
    live = folded.Live(cfg, ir, "cpu")
    st = live.init_state(2)
    x = torch.randn((2, 2, 512 * 40), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4)) * 0.25
    ys = []
    for b in range(40):
        st, y = live.step(st, x[..., b * 512:(b + 1) * 512])
        ys.append(y)
    ref = R.run_chain(x, _h(cfg, ir, False), cfg["chain"], 48000.0)
    assert float((torch.cat(ys, -1) - ref).norm() / ref.norm()) < 1e-12


def test_soft_clip_and_dc_blocker_match_port():
    from convopeq_tpu_torch.ops.dc_blocker import dc_block
    from convopeq_tpu_torch.ops.softclip import (soft_clip_local2x,
                                                 soft_clip_params)
    x = torch.randn((3, 20000), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5)) * 0.6
    a = soft_clip_local2x(x, *soft_clip_params(0.3))
    assert float((a - R.soft_clip_local2x(x, 0.3)).abs().max()) < 1e-14
    b, _ = dc_block(x, 384000.0, 3.0)
    assert float((b - R.dc_block(x, 384000.0)).abs().max()) < 1e-13


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantizer_bit_for_bit(dtype):
    from convopeq_tpu_torch.models.dither import ADAPTIVE9, apply_dither
    cfg = _cfg("master384k_d24")
    k = cfg["dither"]["reflection_coeffs"]
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 2000)) * 0.3).astype(dtype)
    u = rng.random((4, 2000, 2)).astype(dtype)
    q = lattice_quantize(x, u, k, 24, C.K_OUTPUT_HEADROOM)
    qp = apply_dither(torch.tensor(x), ADAPTIVE9, 384000.0, 24,
                      uniforms=torch.tensor(u), adaptive_coeffs=np.array(k),
                      lattice_ladder="fir")
    assert np.array_equal(q, qp.numpy())


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (harness.ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "__future__"), \
                    (path.name, n)
