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


# a warp-per-job kernel: a row loop around a strip loop (shared loads and
# stores, shuffles, a warp reduction, a vote) around a scan loop of
# shuffles; no loop stores to global memory
WARP_SASS = """
        Function : _ZN12_GLOBAL__N_113extend_kernelILi0EEEvPKiS2_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDG.E.CONSTANT R10, desc[UR4][R2.64] ;
.L_x_2:
        /*0020*/                   LDS.64 R8, [R4] ;
        /*0030*/                   VIMNMX R12, R8, R9, !PT ;
.L_x_3:
        /*0040*/                   SHFL.UP PT, R13, R12, R6, RZ ;
        /*0050*/               @P1 VIMNMX R12, R12, R13, !PT ;
        /*0060*/                   ISETP.LT.AND P2, PT, R6, R7, PT ;
        /*0070*/              @!P2 BRA P6, 0x40 ;
        /*0080*/                   SHFL.IDX PT, R14, R12, 0x1f, 0x1f ;
        /*0090*/                   REDUX.MAX.S32 UR6, R12 ;
        /*00a0*/                   VOTE.ANY R15, PT, P3 ;
        /*00b0*/                   NOP ;
        /*00c0*/                   STS.64 [R4], R12 ;
        /*00d0*/               @P4 BRA `(.L_x_2) ;
        /*00e0*/                   WARPSYNC.ALL ;
        /*00f0*/               @P5 BRA `(.L_x_1) ;
        /*0100*/                   STG.E desc[UR4][R16.64], R12 ;
        /*0110*/                   EXIT ;
"""


def test_sass_class_knows_the_warp_operations():
    for op in ("SHFL.UP PT, R13, R12, R6, RZ", "REDUX.MAX.S32 UR6, R12",
               "VOTE.ANY R15, PT, P3"):
        assert c.sass_class(op) == "warp"
    assert c.sass_class("LDS.64 R8, [R4]") == "memory"


def test_strip_loop_of_a_warp_per_job_kernel():
    info = c.sass_strip_loop(WARP_SASS, r"extend_kernelILi0EE")
    assert info == {
        "function": "_ZN12_GLOBAL__N_113extend_kernelILi0EEEvPKiS2_",
        "loops": 3, "instructions": 11, "nested_loops": 1, "shfl": 2,
        "redux": 1, "vote": 1, "lds": 1, "sts": 1,
        "opcodes": {"BRA": 2, "ISETP.LT.AND": 1, "LDS.64": 1,
                    "REDUX.MAX.S32": 1, "SHFL.IDX": 1, "SHFL.UP": 1,
                    "STS.64": 1, "VIMNMX": 2, "VOTE.ANY": 1}}
    # a one-thread-per-job kernel has no such loop: information, no error
    assert c.sass_strip_loop(SASS, r"kernel") is None
    # the scan loop's back branch carries a second predicate as an
    # operand; the band-loop analysis of the other rows does not take it
    assert len(c.sass_function(WARP_SASS, r"extend_kernel")[2]) == 2


def test_strip_loop_opcodes_count_each_instruction():
    """The opcodes show K1-i16's 16x2 operations as single instructions;
    guards are not part of an opcode, NOPs are not counted."""
    info = c.sass_strip_loop(WARP_SASS, r"extend_kernelILi0EE")
    assert sum(info["opcodes"].values()) == info["instructions"]
    guarded = WARP_SASS.replace("VIMNMX R12, R8, R9, !PT",
                                "VIADDMNMX.S16x2 R12, R8, R9, R10, !PT")
    ops = c.sass_strip_loop(guarded, r"extend_kernelILi0EE")["opcodes"]
    assert ops["VIADDMNMX.S16x2"] == 1 and ops["VIMNMX"] == 1


def test_no_global_store_in_a_loop_raises_only_for_sass_read_rows():
    """No row of the kernels line reads its band loop in SASS any more:
    each takes its work per cell from RECURRENCE_OPS, so a kernel whose
    loops keep the row in shared memory (every kernel since K1-bd's
    redesign) bounds all the same.  sass_loops, which read the one-thread
    band loops those constants came from, raises on such a kernel."""
    with pytest.raises(AssertionError, match="no inner band loop"):
        c.sass_loops(WARP_SASS, r"extend_kernelILi0EE")
    assert {r for *_, ops in c.KERNEL_ROWS
            for r in ops.values()} <= set(c.RECURRENCE_OPS)
    names = [row[0] for row in c.KERNEL_ROWS]
    assert len(names) == len(set(names)) == 6
    rates = {"int32_per_s": 132 * 64 * 1980e6,
             "issue_per_s": 132 * 128 * 1980e6}
    for *_, ops in c.KERNEL_ROWS:
        case = {"cells": 11_384_096, "bytes": 12_779_520,
                "live_cells": 8_384_096, "frozen_cells": 3_000_000}
        ms, by, parts = c.bound(case, c.cell_ops(case, ops), rates)
        assert by == "operations"


def test_the_bd_row_pins_the_live_pass_baseline():
    """K1-bd's row reads extend_bd_live<kTable, no N cap, scan, roll,
    reduce, trim>, the instantiation baseline and unroll2 share, by its
    mangled name among the live and frozen instantiations."""
    function = dict((r[0], r[3]) for r in c.KERNEL_ROWS)["ksw_extend_bd"]
    live = "_ZN12_GLOBAL__N_114extend_bd_liveILi{}ELb{}ELb1ELb1ELb1ELb{}EEEvPKiS2_S2_P4int2Piiiii"
    frozen = ("_ZN12_GLOBAL__N_116extend_bd_frozenILi0ELi1ELb0ELb1ELb1ELb1"
              "ELb1EEEvPKiS2_S2_PiPK4int2S2_iiiiii")
    names = [live.format(0, 0, 1), live.format(1, 0, 1),
             live.format(0, 1, 1), live.format(0, 0, 0), frozen]
    assert [n for n in names if re.search(function, n)] == [names[0]]


# the band cells of the main shape (make_jobs W 128, tmax 256, N 8,192,
# zdrop 100) as the plain versions count them, and the bounds they give
# at an H100's rates (132 SMs, 1,980 MHz)
@pytest.mark.parametrize("name,cells,want_ms", [
    ("ksw_extend", 11_384_096, 0.009018),
    ("ksw_extend_real", 12_317_898, 0.009021),
    ("ksw_extend_floor", 7_826_210, 0.005264),
    ("ksw_extend16", 11_504_743, 0.004557),
    ("ksw_extend_bd", 14_024_874, 0.009223),
])
def test_recurrence_constants_give_the_recorded_bounds(name, cells, want_ms):
    rates = {"int32_per_s": 132 * c.INT32_LANES * 1980e6,
             "issue_per_s": 132 * c.SCHED_LANES * 1980e6}
    case = {"cells": cells, "bytes": 4 * (8192 * (128 + 256 + 5 + 6))}
    ms, by, parts = c.bound(case, c.RECURRENCE_OPS[name], rates)
    assert by == "operations" and round(ms, 6) == want_ms
    assert ms == parts["int_alu_ms"] > max(parts["issue_ms"],
                                           parts["bytes_ms"])


def test_the_bd_row_charges_live_and_frozen_cells_their_own_work():
    """K1-bd's frozen cells need neither F nor the E update: at the main
    shape (10,780,357 live and 3,244,517 frozen of 14,024,874 cells) the
    bound is 0.008641 ms, where every cell at the live constant would
    give 0.009223; the counts must add up to the cells."""
    charge = dict((r[0], r[4]) for r in c.KERNEL_ROWS)["ksw_extend_bd"]
    assert charge == {"live_cells": "ksw_extend_bd",
                      "frozen_cells": "ksw_extend_bd_frozen"}
    live, frozen = (c.RECURRENCE_OPS[k] for k in charge.values())
    assert (live["alu_per_cell"] - frozen["alu_per_cell"]
            == live["int_per_cell"] - frozen["int_per_cell"] == 3.0)
    rates = {"int32_per_s": 132 * c.INT32_LANES * 1980e6,
             "issue_per_s": 132 * c.SCHED_LANES * 1980e6}
    case = {"cells": 14_024_874, "live_cells": 10_780_357,
            "frozen_cells": 3_244_517,
            "bytes": 4 * (8192 * (128 + 256 + 5 + 128))}
    ms, by, parts = c.bound(case, c.cell_ops(case, charge), rates)
    assert by == "operations" and round(ms, 6) == 0.008641
    assert ms == parts["int_alu_ms"] > max(parts["issue_ms"],
                                           parts["bytes_ms"])
    with pytest.raises(AssertionError, match="do not add up"):
        c.cell_ops(dict(case, frozen_cells=0), charge)


PTXAS = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113extend_kernelILi1EEEvPKi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113extend_kernelILi1EEEvPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, 0 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113extend_kernelILi0EEEvPKi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113extend_kernelILi0EEEvPKi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 0 bytes cmem[0]
"""


def test_ptxas_usage_of_one_instantiation():
    assert c.ptxas_usage(PTXAS, r"extend_kernelILi0EE") == {
        "registers": 40, "spill_bytes": 8}
    assert c.ptxas_usage(PTXAS, r"extend_kernelILi1EE") == {
        "registers": 38, "spill_bytes": 0}
    with pytest.raises(AssertionError, match="2 functions match"):
        c.ptxas_usage(PTXAS, r"extend_kernel")


def test_bound_takes_the_larger_limit():
    rates = {"int32_per_s": 64e12, "issue_per_s": 128e12}
    loop = {"alu_per_cell": 12.0, "int_per_cell": 14.0}
    case = {"cells": 1e9, "bytes": 1e6}
    ms, by, parts = c.bound(case, loop, rates)
    # ALU ops over the INT32 pipe (0.1875 ms) beat all of them over issue
    assert by == "operations" and ms == pytest.approx(0.1875)
    assert parts["issue_ms"] == pytest.approx(14e9 / 128e12 * 1e3)
    assert set(parts) == {"bytes_ms", "int_alu_ms", "issue_ms"}
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


def test_sectors_count_each_touched_sector_once():
    """By hand: 48-byte occ rows 0, 1, 1 and 2 lie in bytes [0, 48),
    [48, 96) and [96, 144): sectors {0, 1}, {1, 2} and {3, 4}, five in
    all; 32-byte rows are one sector each; 4-byte values 0-7 share
    sector 0 and value 8 starts sector 1."""
    assert c.sectors([0, 1, 1, 2], 48) == 5
    assert c.sectors([2, 1, 0, 1], 48) == 5         # order is no matter
    assert c.sectors([5, 5, 9], 32) == 2
    assert c.sectors(range(8), 4) == 1 and c.sectors(range(9), 4) == 2
    assert c.sectors([], 48) == 0


def test_the_fm_rows_are_bound_by_their_bytes_alone():
    """A K-sa launch of 3 int32 ranks that took LF steps on occ rows 0,
    1, 1 and 2 (five sectors), tested marks on mark rows 0 and 0 (one)
    and read sa_marked[3] and [40] (two): 2 x 3 x 4 bytes of ranks and
    positions, and 32 bytes a sector for those 8 and for L2."""
    nbytes = c.fm_bytes(2 * 3 * 4, [([0, 1, 1, 2], c.OCC_ROW),
                                    ([0, 0], c.MARK_ROW), ([3, 40], 4)])
    assert nbytes == 24 + 32 * (5 + 1 + 2 + 1)
    ms, by, parts = c.bytes_bound({"bytes": nbytes})
    assert by == "bytes" and ms == parts["bytes_ms"]
    assert ms == pytest.approx(312 / c.HBM_BYTES_S * 1e3)
    # a row with no band cells takes no part of the cells' bound
    with pytest.raises(KeyError):
        c.bound({"bytes": nbytes}, c.RECURRENCE_OPS["ksw_extend"], {})


# occ4's word loop as one thread a read compiles it: one 32-bit load a
# trip, its value counted before the back branch; then a row fetched as
# three 16-byte loads in straight-line code
LOADS = """
        Function : _Z5occ4sPj
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_2:
        /*0010*/                   LDG.E.CONSTANT R8, desc[UR4][R4.64] ;
        /*0020*/                   LOP3.LUT R9, R8, R12, RZ, 0x3c, !PT ;
        /*0030*/                   POPC R9, R9 ;
        /*0040*/                   IADD3 R4, P1, R4, 0x4, RZ ;
        /*0050*/                   ISETP.NE.AND P3, PT, R18, RZ, PT ;
        /*0060*/               @P3 BRA `(.L_x_2) ;
        /*0070*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64] ;
        /*0080*/                   LDG.E.128.CONSTANT R16, desc[UR4][R2.64+0x10] ;
        /*0090*/                   LDG.E.128.CONSTANT R20, desc[UR4][R2.64+0x20] ;
.L_x_3:
        /*00a0*/                   LDG.E.CONSTANT R8, desc[UR4][R6.64] ;
        /*00b0*/                   IADD3 R6, P1, R6, 0x4, RZ ;
        /*00c0*/                   ISETP.NE.AND P4, PT, R19, RZ, PT ;
        /*00d0*/               @P4 BRA `(.L_x_3) ;
        /*00e0*/                   EXIT ;
"""


def test_sass_loads_counts_widths_and_loops_that_wait():
    """Five loads: three 128-bit, two 32-bit in two loops; the first
    loop reads its load's value (POPC of the LOP3 of R8) before its back
    branch, the second never does."""
    got = c.sass_loads(LOADS, r"occ4")
    assert got["ldg"] == {"32": 2, "128": 3}
    assert got["loops"] == [
        {"at": "0x10", "instructions": 6, "ldg": {"32": 1}, "waits": True},
        {"at": "0xa0", "instructions": 4, "ldg": {"32": 1}, "waits": False}]


# one LF step a trip of a walk loop: in _Z3onePj the row's three 16-byte
# loads are issued before any is read (one round); in _Z3twoPj the
# second load's address is read off the first's result (two rounds)
ROUNDS = """
        Function : _Z3onePj
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.128.CONSTANT R16, desc[UR4][R2.64+0x10] ;
        /*0030*/                   LDG.E.128.CONSTANT R20, desc[UR4][R2.64+0x20] ;
        /*0040*/                   LOP3.LUT R9, R16, R12, RZ, 0x3c, !PT ;
        /*0050*/                   POPC R9, R9 ;
        /*0060*/                   IMAD.WIDE R2, R9, 0x30, R4 ;
        /*0070*/                   ISETP.NE.AND P3, PT, R9, RZ, PT ;
        /*0080*/               @P3 BRA `(.L_x_0) ;
        /*0090*/                   LDG.E R8, desc[UR4][R6.64] ;
        /*00a0*/                   EXIT ;
        Function : _Z3twoPj
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
.L_x_1:
        /*0000*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64] ;
        /*0010*/                   LDG.E R8, desc[UR4][R6.64] ;
        /*0020*/                   IMAD.WIDE R4, R13, 0x30, R10 ;
        /*0030*/                   LDG.E.128.CONSTANT R16, desc[UR4][R4.64] ;
        /*0040*/                   IADD3 R2, R16, R8, RZ ;
        /*0050*/                   ISETP.NE.AND P3, PT, R2, RZ, PT ;
        /*0060*/               @P3 BRA `(.L_x_1) ;
        /*0070*/                   EXIT ;
"""


@pytest.mark.parametrize("function,rounds,ldg", [
    (r"_Z3onePj", 1, {"128": 3}), (r"_Z3twoPj", 2, {"128": 2, "32": 1})])
def test_load_rounds_counts_the_trips_of_a_step(function, rounds, ldg):
    got = c.load_rounds(ROUNDS, function)
    assert got["rounds_128"] == rounds and got["ldg"] == ldg
    assert got["ldg128"] == ldg["128"] and got["loop_at"] == (
        "0x10" if rounds == 1 else "0x0")



# a lockstep step: two 16-byte row loads and one 8-byte one, issued
# before any is read, after the byte load of the step's base, which the
# branch reads
STEP = """
        Function : _Z4stepPj
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
.L_x_0:
        /*0000*/                   LDG.E.U8.CONSTANT R9, desc[UR4][R4.64] ;
        /*0010*/                   ISETP.GT.AND P1, PT, R9, 0x3, PT ;
        /*0020*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64] ;
        /*0030*/                   LDG.E.128.CONSTANT R16, desc[UR4][R10.64] ;
        /*0040*/                   LDG.E.64.CONSTANT R20, desc[UR4][R8.64] ;
        /*0050*/                   LOP3.LUT R22, R20, R12, RZ, 0x3c, !PT ;
        /*0060*/                   IADD3 R2, R22, R16, RZ ;
        /*0070*/               @P0 BRA `(.L_x_0) ;
        /*0080*/                   EXIT ;
"""


@pytest.mark.parametrize("min_width,rounds", [(128, 1), (64, 1), (32, 2)])
def test_load_rounds_counts_the_loads_from_min_width(min_width, rounds):
    """The 8-byte load joins the 16-byte ones' round from min_width 64
    on; at 32 the byte load, read by the branch, is a round of its
    own."""
    got = c.load_rounds(STEP, r"_Z4stepPj", min_width=min_width)
    assert got["loop_at"] == "0x0"
    assert got["ldg"] == {"128": 2, "64": 1, "32": 1}
    assert got["rounds_128"] == 1 and got["rounds"] == rounds
