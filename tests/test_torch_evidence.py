"""The evidence export of convopeq_tpu_torch (`runtime/evidence.py`,
`ConvoPeqEngine.export_evidence_dir`) on the CPU against convopeq_tpu's.

- For the same engine activity (an IR loaded, EQ bands set, dither set),
  the same artifact names and the same keys an artifact as the JAX
  exporter, apart from the payload tier's keys that name the JAX backend
  (JAX_ONLY_TIER_KEYS) and the port's device keys in their place
  (PORT_ONLY_TIER_KEYS); no builder failed.
- The run-id override (CONVOPEQ_RUN_ID, then the reference's
  CONVO_ISR_RUNTIME_RUN_ID), `enrich`'s inject-only-when-absent rule, and
  tamper detection: an edited artifact, a deleted one and an edited
  manifest each fail `verify_evidence_dir`.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.engine import ConvoPeqEngine as JEngine
from convopeq_tpu.runtime import evidence as jev
from convopeq_tpu_torch.engine import ConvoPeqEngine as TEngine
from convopeq_tpu_torch.runtime import evidence as tev

SR = 48000.0
JAX_ONLY_TIER_KEYS = {"backend", "kernel_gates"}
PORT_ONLY_TIER_KEYS = {"device", "card", "dtype_tiers", "kernel_launches"}


def _activity(eng, ir):
    eng.load_impulse_response(ir, SR)
    eng.set_eq_band(0, band_type=1, freq=1000.0, gain_db=4.0, q=1.4,
                    enabled=True)
    eng.set_dither(0, 24)
    return eng


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("evidence")
    ir = np.random.default_rng(2).normal(size=(2, 3000)) \
        * np.exp(-np.arange(3000) / 600.0) * 0.3
    j = _activity(JEngine(SR, 512, dtype=jnp.float64,
                          mixed_phase_cache_dir=root / "mpj"), ir)
    t = _activity(TEngine(SR, 512, dtype=torch.float64, device="cpu",
                          mixed_phase_cache_dir=root / "mpt"), ir)
    mj = jev.EvidenceExporter(j).export(root / "jax")
    mt = t.export_evidence_dir(root / "port")
    return root, mj, mt


def test_same_artifacts_and_keys_as_jax(exported):
    root, mj, mt = exported
    assert sorted(mt["artifacts"]) == sorted(mj["artifacts"])
    assert mt["artifactCount"] == mj["artifactCount"] == 16
    assert sorted(p.name for p in (root / "port").iterdir()) == \
        sorted(p.name for p in (root / "jax").iterdir())
    for name in mj["artifacts"]:
        a = json.loads((root / "port" / name).read_text())
        b = json.loads((root / "jax" / name).read_text())
        assert "error" not in a, (name, a.get("error"))
        ka, kb = set(a), set(b)
        if name == "payload_tier_report.json":
            assert ka - kb == PORT_ONLY_TIER_KEYS
            assert kb - ka == JAX_ONLY_TIER_KEYS
        else:
            assert ka == kb, name
    tier = json.loads((root / "port" / "payload_tier_report.json")
                      .read_text())
    assert tier["device"] == "cpu" and tier["card"] is None
    assert tier["engine_dtype"] == "torch.float64"
    assert set(tier["kernel_launches"]) >= {"frames_rfft", "causal_mac",
                                            "irfft_valid",
                                            "error_feedback_quantize"}
    auth = json.loads((root / "port" /
                       "authority_verification_report.json").read_text())
    assert auth["verified"] is True
    for name in ("latency_report.json", "convolver_build_report.json",
                 "gain_plan_report.json", "dsp_chain_report.json",
                 "world_lifecycle_audit.json"):
        a = json.loads((root / "port" / name).read_text())
        b = json.loads((root / "jax" / name).read_text())
        for k in a:
            if k not in ("generatedAtNs", "ir_content_key"):
                assert a[k] == b[k], (name, k)


def test_manifest_verifies_and_tamper_fails(exported, tmp_path):
    root, _, _ = exported
    import shutil
    d = tmp_path / "copy"
    shutil.copytree(root / "port", d)
    ok = tev.verify_evidence_dir(d)
    assert ok == {"ok": True, "mismatches": [], "missing": [],
                  "artifactCount": 16}
    art = d / "latency_report.json"
    art.write_text(art.read_text().replace("samples", "sampleZ", 1))
    bad = tev.verify_evidence_dir(d)
    assert not bad["ok"] and bad["mismatches"] == ["latency_report.json"]
    (d / "cache_report.json").unlink()
    assert tev.verify_evidence_dir(d)["missing"] == ["cache_report.json"]
    m = d / "evidence_manifest.json"
    m.write_text(m.read_text() + " ")
    assert "evidence_manifest.json" in \
        tev.verify_evidence_dir(d)["mismatches"]


def test_run_id_and_enrich(monkeypatch, tmp_path):
    monkeypatch.delenv(tev.RUN_ID_ENV, raising=False)
    monkeypatch.delenv(tev.RUN_ID_ENV_REF, raising=False)
    assert tev.resolve_run_id() == jev.resolve_run_id() == "runtime-local"
    monkeypatch.setenv("CONVO_ISR_RUNTIME_RUN_ID", "ref-run")
    assert tev.resolve_run_id() == "ref-run"
    monkeypatch.setenv("CONVOPEQ_RUN_ID", "own-run")
    assert tev.resolve_run_id() == jev.resolve_run_id() == "own-run"
    e = tev.enrich({"runId": "kept", "x": 1}, "a.json")
    assert e["runId"] == "kept" and e["artifact"] == "a.json"
    assert e["provenance"] == "runtime" and isinstance(e["generatedAtNs"],
                                                       int)
    assert set(e) == set(jev.enrich({"runId": "kept", "x": 1}, "a.json"))
    eng = TEngine(SR, 512, dtype=torch.float64, device="cpu",
                  mixed_phase_cache_dir=tmp_path / "mp")
    man = eng.export_evidence_dir(tmp_path / "ev")
    assert man["runId"] == "own-run"
    snap = json.loads((tmp_path / "ev" / "runtime_snapshot.json")
                      .read_text())
    assert snap["runId"] == "own-run" and "partition_plan" not in snap
