"""The quantizer probe's readers of the CUDA toolchain's output
(convopeq_tpu_torch/sweep.py `ptxas_report`, `sass_loops`) and its
table of the step's dependent chain, on the CPU.  The probe itself
(csrc/ef_probe.cu) runs only on the card: `python -m
convopeq_tpu_torch.sweep probe`."""
import pytest

from convopeq_tpu_torch import sweep
from convopeq_tpu_torch.ops import quantize_kernels as qk

KERNEL = ("_ZN12_GLOBAL__N_118ef_quantize_kernelIfLi4ELi9EEEv"
          "NS_6EfArgsIT_EENS_8EfConstsIS2_EE")


def test_ptxas_report_reads_registers_stack_and_spills():
    log = (f"ptxas info    : Compiling entry function '{KERNEL}' for "
           "'sm_90a'\n"
           f"ptxas info    : Function properties for {KERNEL}\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 80 registers, used 0 barriers, 400 bytes "
           "cmem[0]\n")
    rep = sweep.ptxas_report(log)
    assert list(rep) == [sweep._short(KERNEL)]
    assert rep[sweep._short(KERNEL)] == (
        "80 registers, 8 bytes stack frame, 4 bytes spill stores, "
        "4 bytes spill loads")


def _sass(body_ops, branch_to):
    lines = ["\tcode for sm_90a", f"\t\tFunction : {KERNEL}",
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
             "   /* 0x00000a00ff017b82 */",
             "                                       /* 0x000fe2000000080"
             "0 */"]
    addr = 0x10
    for op in body_ops:
        lines.append(f"        /*{addr:04x}*/                   {op} ;"
                     "   /* 0x0000000000000000 */")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/              @!P0 BRA "
                 f"{branch_to:#x} ;   /* 0x0000000000000000 */")
    lines.append(f"        /*{addr + 0x10:04x}*/                   EXIT ;"
                 "   /* 0x0000000000000000 */")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("branch_to, n", [(0x10, 31), (0x30, 29),
                                          (0x200, None)])
def test_sass_loops_counts_a_backward_branchs_span(tmp_path, monkeypatch,
                                                   branch_to, n):
    ops = (["FADD R2, R2, R3"] * 12 + ["FMNMX.NAN R2, R2, -1, !PT"] * 8
           + ["LDS.128 R4, [R8]", "STS.128 [R8], R4", "FRND R2, R2"]
           + ["FMUL R3, R2, UR4"] * 7)
    text = _sass(ops, branch_to)

    class Done:
        stdout = text
    monkeypatch.setattr(sweep.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.setattr(sweep, "_tool", lambda name: name)
    monkeypatch.setattr(sweep, "SASS_DIR", tmp_path)
    loops = sweep.sass_loops("lib.so", "lib.sass")[sweep._short(KERNEL)]
    assert (tmp_path / "lib.sass").read_text() == text
    if n is None:                    # a forward branch is no loop
        assert loops == []
        return
    (loop,) = loops
    assert loop["n"] == n and loop["from"] == hex(branch_to)
    skipped = (branch_to - 0x10) // 0x10      # FADDs before the target
    assert loop["FADD"] == 12 - skipped and loop["FMNMX"] == 8
    assert loop["LDS"] == 1 and loop["STS"] == 1 and loop["FRND"] == 1
    assert loop["FMUL"] == 7 and loop["LDL"] == 0 and loop["STL"] == 0


def test_chain_table_covers_every_mode():
    assert set(sweep.CHAIN_OPS) == set(qk.MODES)
    assert all(len(c) == 3 and c[2] == 1 for c in sweep.CHAIN_OPS.values())


def test_chain_cycles_add_each_modes_rounding():
    """Each mode's chain: its adds and clamps at the probe's latencies and
    one rounding of each form, with the clamp of q in the modes that
    clamp it; the rint form is the table's earlier count, multiplies and
    FRND apart."""
    per_op = {"FADD": 4.0, "FMUL": 4.0, "FMUL+clamp": 12.0, "FRND": 17.0,
              "DADD": 8.0, "DMUL": 8.0, "DMUL+clamp": 26.0}
    per_op.update({name: 100.0 + i for i, name in
                   enumerate(sweep.ROUNDINGS)})
    assert len(sweep.PROBE_OPS) == 11 + len(sweep.ROUNDINGS) == 19
    got = sweep.chain_cycles(per_op)
    assert len(got) == 2 * 2 * len(qk.MODES)
    assert got["psycho f32 rint"] == 14 * 4.0 + 100.0
    assert got["psycho f32 fold"] == 14 * 4.0 + 101.0
    assert got["fixed f32 fold"] == 7 * 4.0 + 2 * 8.0 + 101.0
    assert got["lattice_fir f32 rint"] == 14 * 4.0 + 3 * 8.0 + 102.0
    assert got["lattice_fir f32 fold"] == 14 * 4.0 + 3 * 8.0 + 103.0
    assert got["fixed15 f64 fold"] == 19 * 8.0 + 2 * 18.0 + 107.0
    # with the rounding as FMUL, FRND, FMUL (and a clamp), the earlier
    # table's count: psycho 16 adds and multiplies and a rint
    per_op.update({"round f32 rint": 4.0 + 17.0 + 4.0,
                   "round+clamp f32 rint": 4.0 + 17.0 + 4.0 + 8.0})
    got = sweep.chain_cycles(per_op)
    assert got["psycho f32 rint"] == 16 * 4.0 + 17.0
    assert got["lattice_fir f32 rint"] == 16 * 4.0 + 4 * 8.0 + 17.0
