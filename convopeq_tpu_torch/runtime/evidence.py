"""Structured evidence/audit export, the ISREvidenceExporter analog
(counterpart of convopeq_tpu/runtime/evidence.py).

The reference dumps 53 JSON audit artifacts into an `evidence/` directory
(src/audioengine/ISREvidenceExporter.cpp:1-470, ARCHITECTURE.md:336-345):
per-subsystem reports plus a manifest, each enriched with provenance
metadata before writing — a runId (overridable via the
CONVO_ISR_RUNTIME_RUN_ID env var, cpp:93-97), generatedAtNs, and a
provenance tag, injected only when the payload does not already carry
them (cpp:104-137) — and a manifest hash for tamper evidence
(verifier_manifest_hash.txt).

Most of the reference's 53 reports audit the RCU world-publication
machinery (epoch reclaim, happens-before graphs, retire timelines) that
this framework's functional state threading replaces by design
(PARITY.md §2.3): a cached chain closure IS the sealed world, publication
IS the content-keyed cache insert, and there is no reclamation to audit.
This exporter emits the analog audit set for the subsystems that DO
exist here — one structured artifact per subsystem, same enrichment and
manifest-hash contract:

  runtime_snapshot.json           engine/runtime configuration of record
  deferred_health.json            health ladder + XRUN counters + history
  recovery_trace.json             policy-level transitions with actions
  runtime_budget_report.json      per-stage wall/budget statistics
  publication_progress_log.json   compiled-chain publications (cache keys)
  publication_failure_log.json    failure-category diagnostic records
  payload_tier_report.json        kernel path: device, card, dtype tiers,
                                  each kernel's launch count
  authority_verification_report.json  config authority: state round-trip
  cache_report.json               prepared/chain RAM LRUs + disk cache
  learner_report.json             adaptive-shaper banks + live session
  crossfade_trace.json            transition-authority activations
  world_lifecycle_audit.json      IR generation lifecycle
  latency_report.json             LatencyBreakdown of record
  convolver_build_report.json     per-channel NUC partition plan
  gain_plan_report.json           AutoGainPlanner staging decision
  dsp_chain_report.json           live stage order/topology snapshot
  evidence_manifest.json          artifact list + sha256 each
  verifier_manifest_hash.txt      sha256 of the manifest file
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict
from pathlib import Path

import torch

# The reference reads CONVO_ISR_RUNTIME_RUN_ID (ISREvidenceExporter.cpp:93);
# same contract, framework-native name first, reference name honored.
RUN_ID_ENV = "CONVOPEQ_RUN_ID"
RUN_ID_ENV_REF = "CONVO_ISR_RUNTIME_RUN_ID"
DEFAULT_RUN_ID = "runtime-local"            # cpp:97

FAILURE_CATEGORIES = ("xrun", "learning_error", "learning_stop_timeout",
                      "sanitize", "failure")


def resolve_run_id() -> str:
    for env in (RUN_ID_ENV, RUN_ID_ENV_REF):
        v = os.environ.get(env)
        if v:
            return v
    return DEFAULT_RUN_ID


def enrich(payload: dict, artifact: str, run_id: str | None = None) -> dict:
    """Provenance enrichment (cpp:104-137): adds artifact/provenance/
    runId/generatedAtNs keys, injecting each only when absent."""
    out = dict(payload)
    out.setdefault("artifact", artifact)
    out.setdefault("provenance", "runtime")
    out.setdefault("runId", run_id if run_id is not None else resolve_run_id())
    out.setdefault("generatedAtNs", time.time_ns())
    return out


def _sha256_bytes(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


class EvidenceExporter:
    """Builds the audit artifact set from a live ConvoPeqEngine."""

    def __init__(self, engine):
        self.engine = engine
        self.run_id = resolve_run_id()

    # ------------------------------------------------------------ builders
    def runtime_snapshot(self) -> dict:
        eng = self.engine
        snap = {
            "sample_rate": eng.sample_rate,
            "block_size": eng.block_size,
            "dtype": str(eng.dtype),
            "chain_config": asdict(eng.config),
            "chain_key": repr(eng._chain_key()),
            "phase_mode": eng.phase_mode,
            "dither": {"type": eng.dither_type,
                       "bit_depth": eng.dither_bit_depth},
            "auto_gain_enabled": eng.auto_gain_enabled,
            "crossfade_enabled": eng.crossfade_enabled,
        }
        if eng._conv_state is not None:
            plan = eng._conv_state.left.plan
            snap["partition_plan"] = [
                {"part_size": lp.part_size, "num_parts": lp.num_parts}
                for lp in plan.layers]
            lb = eng.latency_breakdown()
            snap["latency"] = asdict(lb)
            snap["latency_total_samples"] = lb.total_latency_samples
        return snap

    def deferred_health(self) -> dict:
        eng = self.engine
        rep = {
            "health": int(eng.health_monitor.health),
            "health_name": eng.health_monitor.health.name,
            "health_transitions": list(
                getattr(eng.health_monitor, "history", ())),
            "policy_level": int(eng.policy.level),
        }
        if eng._xrun is not None:
            rep["xruns"] = eng._xrun.xruns
            rep["steps"] = eng._xrun.steps
            rep["xrun_threshold_s"] = eng._xrun.threshold_s
        return rep

    def recovery_trace(self) -> dict:
        eng = self.engine
        return {
            "policy_level": int(eng.policy.level),
            "policy_name": eng.policy.level.name,
            "actions": list(eng.policy.actions),
            "transitions": list(getattr(eng.policy, "history", ())),
        }

    def runtime_budget_report(self) -> dict:
        t = self.engine.telemetry
        stages = {}
        for cat, st in t.stage_stats.items():
            stages[cat] = dict(st)
            if st["count"]:
                stages[cat]["mean_us"] = st["total_us"] / st["count"]
        return {"stages": stages, "events_seen": t.seq,
                "events_dropped": t.dropped}

    def publication_progress_log(self) -> dict:
        eng = self.engine
        return {
            "ir_generation": eng._ir_generation,
            "ir_content_key": eng._ir_content_key,
            "published_chain_key": repr(eng._published)
            if eng._published is not None else None,
            "streaming_chain_key": repr(eng._streaming_key)
            if eng._streaming_key is not None else None,
            "compiled_chain_cache_keys": [repr(k) for k in
                                          eng._chain_cache._d.keys()],
            "prepared_ir_cache_keys": [repr(k) for k in
                                       eng._prepared_cache._d.keys()],
        }

    def publication_failure_log(self) -> dict:
        t = self.engine.telemetry
        records = [asdict(e) for e in t.events
                   if e.category in FAILURE_CATEGORIES]
        return {"failureRecordCount": len(records),
                "failureRecords": records}

    def payload_tier_report(self) -> dict:
        """The kernel path of record: the engine's device and, on a card,
        its name and power limit; the dtype tiers; each hand-written
        kernel's launches so far (the wrappers' launch counts)."""
        from ..device import card_description
        from ..ops.dispatch import launches
        dev = self.engine.device
        cuda = dev.type == "cuda"
        return {"device": str(dev),
                "card": card_description() if cuda else None,
                "device_count": torch.cuda.device_count() if cuda else 0,
                "engine_dtype": str(self.engine.dtype),
                "dtype_tiers": {
                    "float32": "f32 frame kernels, fused_conv, soft clip, "
                               "IIR cascade, f32 quantizer",
                    "float64": "f64 frame kernels (native complex128), "
                               "soft clip, IIR cascade, f64 quantizer"},
                "kernel_launches": launches()}

    def authority_verification_report(self) -> dict:
        """Config-authority verification: the serialized state is the
        single authority — it must round-trip through load_state into an
        engine that re-serializes byte-identically AND re-derives the
        same chain key (the reference's authority_* report family checks
        the same invariant for its sealed config worlds)."""
        eng = self.engine
        state_json = eng.save_state()
        state_hash = _sha256_bytes(state_json.encode())
        try:
            clone = type(eng)(sample_rate=eng.sample_rate,
                              block_size=eng.block_size, dtype=eng.dtype,
                              device=eng.device)
            clone.load_state(state_json)
            rt_json = clone.save_state()
            rt_hash = _sha256_bytes(rt_json.encode())
            # compare config-derived key components only — the IR content
            # key (last element) is deliberately outside the preset, as in
            # the reference (IR files are loaded separately from state)
            key_match = (repr(clone._chain_key(strip_mix=True)[:-1])
                         == repr(eng._chain_key(strip_mix=True)[:-1]))
            verified = (rt_hash == state_hash) and key_match
            report = {"state_sha256": state_hash,
                      "roundtrip_sha256": rt_hash,
                      "chain_key_match": key_match,
                      "verified": verified}
        except Exception as e:                       # noqa: BLE001
            report = {"state_sha256": state_hash, "verified": False,
                      "error": repr(e)}
        return report

    def cache_report(self) -> dict:
        eng = self.engine
        disk = eng._mp_cache
        disk_entries = sorted(p.name for p in disk.dir.glob("*.npz"))
        return {
            "prepared_ir_cache": {"entries": len(eng._prepared_cache),
                                  "max_entries":
                                      eng._prepared_cache.max_entries},
            "compiled_chain_cache": {"entries": len(eng._chain_cache),
                                     "max_entries":
                                         eng._chain_cache.max_entries},
            "mixed_phase_disk_cache": {"dir": str(disk.dir),
                                       "entries": len(disk_entries),
                                       "files": disk_entries,
                                       "max_entries": disk.max_entries},
        }

    def learner_report(self) -> dict:
        eng = self.engine
        banks = eng.adaptive_banks.to_dict()
        rep = {"learning_mode": eng.learning_mode,
               "session_active": eng._learner is not None,
               "banks_populated": len(banks)}
        if eng._learner is not None:
            rep["session"] = {
                "generation": eng._learner.generation,
                "best_score": float(eng._learner.best_score),
                "phase": eng._learner.phase,
                "accumulated_seconds": eng._learner.accumulated_seconds,
            }
        return rep

    def crossfade_trace(self) -> dict:
        t = self.engine.telemetry
        events = [asdict(e) for e in t.events if e.category == "crossfade"]
        return {"crossfadeCount": t.stage_stats.get(
                    "crossfade", {}).get("count", 0),
                "recent": events}

    def world_lifecycle_audit(self) -> dict:
        eng = self.engine
        return {
            "ir_generation": eng._ir_generation,
            "ir_loaded": eng._conv_state is not None,
            "ir_content_key": eng._ir_content_key,
            "ir_taps": (int(eng._ir_prepared.shape[-1])
                        if eng._ir_prepared is not None else 0),
            "ir_peak_latency": eng._ir_peak_latency,
            "ir_scale": eng._ir_scale,
        }

    def latency_report(self) -> dict:
        """Latency audit (the reference exports its LatencyBreakdown via
        getCurrentLatencyBreakdown, AudioEngine.Processing.Latency.cpp:80;
        the report family mirrors that surface)."""
        lb = self.engine.latency_breakdown()
        return {
            "algorithm_latency_samples": lb.algorithm_latency_samples,
            "ir_peak_latency_samples": lb.ir_peak_latency_samples,
            "oversampling_latency_samples": lb.oversampling_latency_samples,
            "softclip_latency_samples": lb.softclip_latency_samples,
            "total_latency_samples": lb.total_latency_samples,
            "total_latency_ms": round(lb.total_latency_samples /
                                      self.engine.sample_rate * 1e3, 3),
        }

    def convolver_build_report(self) -> dict:
        """NUC build audit: the per-channel partition plan of record —
        the analog of the reference's convolver build/rebuild reports
        (layer sizing at MKLNonUniformConvolver.cpp:738-758)."""
        eng = self.engine
        if eng._conv_state is None:
            return {"ir_loaded": False, "channels": []}
        chans = []
        for name, st in (("left", eng._conv_state.left),
                         ("right", eng._conv_state.right)):
            plan = st.plan
            chans.append({
                "channel": name,
                "direct_taps": int(plan.direct_taps),
                "layers": [{
                    "offset": lp.offset, "length": lp.length,
                    "part_size": lp.part_size, "num_parts": lp.num_parts,
                    "gain": lp.gain,
                    "damped": lp.damping is not None,
                } for lp in plan.layers],
            })
        return {"ir_loaded": True, "block_size": eng.block_size,
                "channels": chans}

    def gain_plan_report(self) -> dict:
        """AutoGainPlanner plan of record (the reference audits its gain
        staging decisions the same way)."""
        eng = self.engine
        p = eng.auto_gain_plan()
        lin = p.linear()
        return {"auto_gain_enabled": eng.auto_gain_enabled,
                "input_headroom_db": p.input_headroom_db,
                "output_makeup_db": p.output_makeup_db,
                "convolver_input_trim_db": p.convolver_input_trim_db,
                "linear": {"input_headroom": lin[0],
                           "output_makeup": lin[1],
                           "convolver_input_trim": lin[2]}}

    def dsp_chain_report(self) -> dict:
        """Stage-order/topology audit: which stages are live and in what
        order (the ProcessingState snapshot the reference's DSPCore
        reports describe, AudioEngine.h:822-848)."""
        from ..models.chain import resolve_oversampling_factor
        eng = self.engine
        cfg = eng.config
        os_factor = resolve_oversampling_factor(cfg.oversampling_factor,
                                                eng.sample_rate)
        return {
            "order": ("eq_then_convolver" if cfg.order == 0
                      else "convolver_then_eq"),
            "eq_bypassed": cfg.eq_bypassed,
            "conv_bypassed": cfg.conv_bypassed,
            "oversampling": {"requested": cfg.oversampling_factor,
                             "resolved": os_factor,
                             "preset": cfg.oversampling_preset},
            "soft_clip_enabled": cfg.soft_clip_enabled,
            "saturation_amount": cfg.saturation_amount,
            "wet_dry_mix": cfg.wet_dry_mix,
            "output_conditioning": {"conv_hc_mode": cfg.conv_hc_mode,
                                    "conv_lc_mode": cfg.conv_lc_mode,
                                    "eq_lpf_mode": cfg.eq_lpf_mode},
            "dither": {"type": eng.dither_type,
                       "bit_depth": eng.dither_bit_depth},
            "eq_method": cfg.eq_method,
        }

    # ------------------------------------------------------------- export
    BUILDERS = {
        "runtime_snapshot.json": runtime_snapshot,
        "deferred_health.json": deferred_health,
        "recovery_trace.json": recovery_trace,
        "runtime_budget_report.json": runtime_budget_report,
        "publication_progress_log.json": publication_progress_log,
        "publication_failure_log.json": publication_failure_log,
        "payload_tier_report.json": payload_tier_report,
        "authority_verification_report.json": authority_verification_report,
        "cache_report.json": cache_report,
        "learner_report.json": learner_report,
        "crossfade_trace.json": crossfade_trace,
        "world_lifecycle_audit.json": world_lifecycle_audit,
        "latency_report.json": latency_report,
        "convolver_build_report.json": convolver_build_report,
        "gain_plan_report.json": gain_plan_report,
        "dsp_chain_report.json": dsp_chain_report,
    }

    def export(self, directory) -> dict:
        """Write every artifact + manifest + manifest hash; returns the
        manifest dict (artifact -> {sha256, bytes})."""
        root = Path(directory)
        root.mkdir(parents=True, exist_ok=True)
        manifest_entries = {}
        for name, builder in self.BUILDERS.items():
            try:
                payload = builder(self)
            except Exception as e:                   # noqa: BLE001
                payload = {"error": repr(e)}
            text = json.dumps(enrich(payload, name, self.run_id), indent=2,
                              default=str) + "\n"
            (root / name).write_text(text)
            manifest_entries[name] = {
                "sha256": _sha256_bytes(text.encode()),
                "bytes": len(text)}
        manifest = enrich({"artifacts": manifest_entries,
                           "artifactCount": len(manifest_entries)},
                          "evidence_manifest.json", self.run_id)
        mtext = json.dumps(manifest, indent=2) + "\n"
        (root / "evidence_manifest.json").write_text(mtext)
        (root / "verifier_manifest_hash.txt").write_text(
            _sha256_bytes(mtext.encode()) + "\n")
        return manifest


def verify_evidence_dir(directory) -> dict:
    """Integrity check of an exported evidence directory: every artifact's
    sha256 matches the manifest, and the manifest matches its hash file.
    Returns {ok, mismatches, missing}."""
    root = Path(directory)
    mtext = (root / "evidence_manifest.json").read_text()
    want = _sha256_bytes(mtext.encode())
    got = (root / "verifier_manifest_hash.txt").read_text().strip()
    manifest = json.loads(mtext)
    mismatches, missing = [], []
    if want != got:
        mismatches.append("evidence_manifest.json")
    for name, entry in manifest["artifacts"].items():
        p = root / name
        if not p.exists():
            missing.append(name)
            continue
        if _sha256_bytes(p.read_text().encode()) != entry["sha256"]:
            mismatches.append(name)
    return {"ok": not mismatches and not missing,
            "mismatches": mismatches, "missing": missing,
            "artifactCount": manifest["artifactCount"]}
