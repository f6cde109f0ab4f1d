"""chip_smoke's kernel bounds: the SASS inner-loop analysis that counts
a kernel's integer work per DP cell, and the bound built from it.  The
disassembly is written out here in cuobjdump's format (the card's
machine runs cuobjdump on the kernels it builds)."""
import re

import pytest

import chip_smoke as c

# one thread's band loop, 2 cells per trip: the scratch address is
# stepped by the loop (IADD3 / IMAD.X, read only as an address), j is
# stepped for the argmax (read by the work), a counter runs down to 0
SASS = """
        Function : _Z6kernelPiS_
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.MOV.U32 R6, RZ, RZ, RZ ;
.L_x_1:
        /*0020*/                   LDG.E.64 R8, desc[UR4][R4.64] ;
        /*0030*/                   LDG.E.CONSTANT R10, desc[UR4][R2.64] ;
        /*0040*/                   ISETP.NE.AND P0, PT, R8, RZ, PT ;
        /*0050*/                   IMAD.IADD R12, R8, 0x1, R10 ;
        /*0060*/                   SEL R12, R12, RZ, P0 ;
        /*0070*/                   VIMNMX3.RELU R13, R12, R9, R14, !PT ;
        /*0080*/                   STG.E.64 desc[UR4][R4.64], R12 ;
        /*0090*/                   IADD3 R4, P1, R4, R16, RZ ;
        /*00a0*/                   IMAD.X R5, R5, 0x1, R17, P1 ;
        /*00b0*/                   ISETP.GE.AND P2, PT, R13, R14, PT ;
        /*00c0*/                   VIMNMX R14, R14, R13, !PT ;
        /*00d0*/               @P2 VIADD R15, R6, 0x1 ;
        /*00e0*/                   LDG.E.64 R8, desc[UR4][R4.64] ;
        /*00f0*/                   VIADDMNMX R12, R8, 0xfffffff9, RZ, !PT ;
        /*0100*/                   STG.E.64 desc[UR4][R4.64], R12 ;
        /*0110*/                   IADD3 R4, P1, R4, R16, RZ ;
        /*0120*/                   IMAD.X R5, R5, 0x1, R17, P1 ;
        /*0130*/                   VIADD R6, R6, 0x2 ;
        /*0140*/                   VIADD R18, R18, 0xfffffffe ;
        /*0150*/                   NOP ;
        /*0160*/                   ISETP.NE.AND P3, PT, R18, RZ, PT ;
        /*0170*/               @P3 BRA `(.L_x_1) ;
        /*0180*/                   EXIT ;
        /*0190*/                   BRA 0x190;
"""


@pytest.mark.parametrize("op,want", [
    ("LDG.E.64 R8, desc[UR4][R4.64]", "memory"),
    ("STG.E.64 desc[UR4][R4.64], R12", "memory"),
    ("LDC.64 R18, c[0x0][0x238]", "memory"),
    ("@P3 BRA `(.L_x_1)", "control"),
    ("IMAD.MOV.U32 R31, RZ, RZ, 0x1", "move"),
    ("ULDC.64 UR6, c[0x0][0x210]", "uniform"),
    ("@!P4 VIADD R22, R25, 0x1", "int_fma"),
    ("IMAD.IADD R20, R20, 0x1, R17", "int_fma"),
    ("VIADDMNMX R19, R20, 0xfffffff9, RZ, !PT", "int_alu"),
    ("ISETP.GT.OR P2, PT, R17, 0x3, P1", "int_alu"),
])
def test_sass_class(op, want):
    assert c.sass_class(op) == want


def test_def_use_reads_pairs_and_addresses():
    assert c.def_use("STG.E.64 desc[UR4][R36.64], R16") == (
        [], ["R36", "R37"], ["R16", "R17"], None)
    writes, addr, reads, guard = c.def_use("IADD3 R4, P1, R4, R16, RZ")
    assert (writes, addr, reads) == (["R4", "P1"], [], ["R4", "R16"])
    writes, _, reads, guard = c.def_use("@P2 VIADD R15, R6, 0x1")
    assert writes == ["R15"] and reads == ["P2", "R6"] and guard
    writes, _, reads, _ = c.def_use("IMAD.WIDE R34, R28, R19, R20")
    assert writes == ["R34", "R35"] and reads == ["R28", "R19", "R20", "R21"]


def test_sass_loops_counts_the_work_per_cell():
    loop = c.sass_loops(SASS, r"kernel")
    assert (loop["stores"], loop["loads"]) == (2, 3)
    assert loop["classes"] == {
        "memory": 5, "int_alu": 6, "int_fma": 3, "address": 4,
        "loop_control": 2, "control": 2}
    # the NOP issues nothing: 22 instructions, 21 issued
    assert loop["instructions"] == 21 and loop["sass_per_cell"] == 10.5
    assert loop["int_per_cell"] == 4.5 and loop["alu_per_cell"] == 3.0
    assert loop["loops"] == 2 and loop["inner_candidates"] == 1


def test_sass_loops_needs_one_function_and_a_band_loop():
    with pytest.raises(AssertionError, match="0 functions match"):
        c.sass_loops(SASS, r"no_such_kernel")
    no_store = SASS.replace("STG.E.64", "MOV")
    with pytest.raises(AssertionError, match="no inner band loop"):
        c.sass_loops(no_store, r"kernel")


def test_bound_takes_the_larger_limit():
    rates = {"int32_per_s": 64e12, "issue_per_s": 128e12}
    loop = {"alu_per_cell": 12.0, "int_per_cell": 14.0, "sass_per_cell": 23.0}
    case = {"cells": 1e9, "bytes": 1e6}
    ms, by, parts = c.bound(case, loop, rates)
    # ALU ops over the INT32 pipe (0.1875 ms) beat all of them over issue
    assert by == "operations" and ms == pytest.approx(0.1875)
    assert parts["issue_ms"] == pytest.approx(14e9 / 128e12 * 1e3)
    assert parts["all_sass_int32_ms"] == pytest.approx(23e9 / 64e12 * 1e3)
    ms, by, _ = c.bound(dict(case, bytes=1e12), loop, rates)
    assert by == "bytes" and ms == pytest.approx(1e12 / c.HBM_BYTES_S * 1e3)


def _two_instantiations():
    """SASS with K1's template instantiated twice, as cuobjdump names
    them: extend_kernel<0> (the loop above) and extend_kernel<1>, whose
    loop lacks one VIMNMX per cell."""
    k0 = SASS.replace("_Z6kernelPiS_",
                      "_ZN12_GLOBAL__N_113extend_kernelILi0EEEvPKiS2_")
    k1 = k0.replace("ILi0EE", "ILi1EE").replace(
        "        /*00c0*/                   VIMNMX R14, R14, R13, !PT ;\n",
        "        /*00c0*/                   NOP ;\n")
    return k0 + k1


@pytest.mark.parametrize("pattern,alu", [(r"extend_kernelILi0EE", 3.0),
                                         (r"extend_kernelILi1EE", 2.5)])
def test_sass_loops_pins_one_template_instantiation(pattern, alu):
    loop = c.sass_loops(_two_instantiations(), pattern)
    assert re.search(pattern, loop["function"])
    assert loop["alu_per_cell"] == alu


def test_sass_loops_bare_name_of_a_template_raises():
    with pytest.raises(AssertionError, match="2 functions match"):
        c.sass_loops(_two_instantiations(), r"extend_kernel")
