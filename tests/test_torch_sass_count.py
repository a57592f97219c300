"""`kwave_tpu_torch.ops.sass_count.parse_loops` on a hand-made ``cuobjdump -sass`` dump (the
tool itself runs only where the CUDA toolkit is)."""

from kwave_tpu_torch.ops import sass_count

DUMP = """
	Function : _ZN3foo8series40ILb1EEEvPKf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00 */
        /*0010*/                   IMAD.MOV.U32 R2, RZ, RZ, RZ ;          /* 0x00 */
        /*0020*/                   LDG.E R4, desc[UR4][R2.64] ;           /* 0x00 */
        /*0030*/                   FMUL R5, R4, R4 ;                      /* 0x00 */
        /*0040*/                   LOP3.LUT R6, R5, 0xff, RZ, 0xc0, !PT ; /* 0x00 */
        /*0050*/                   ISETP.NE.AND P0, PT, R6, RZ, PT ;      /* 0x00 */
        /*0060*/              @P0  BRA 0x20 ;                             /* 0x00 */
        /*0070*/                   EXIT ;                                 /* 0x00 */
        /*0080*/                   BRA 0x80;                              /* 0x00 */
	Function : _ZN3foo7seriesfILb1EEEvPKf
        /*0000*/                   FADD R1, R1, R1 ;                      /* 0x00 */
        /*0010*/                   BRA 0x0 ;                              /* 0x00 */
"""


def test_parse_loops_counts_the_body_of_each_backward_branch_by_class():
    loops = sass_count.parse_loops(DUMP, ("series40",))
    assert loops == [dict(kernel="_ZN3foo8series40ILb1EEEvPKf", start="0x20", end="0x60",
                          instructions=5, fp32=1, integer=2, memory=1, control=1,
                          global_loads=1, innermost=True)]


def test_parse_loops_filters_by_name_and_drops_the_padding_branch():
    both = sass_count.parse_loops(DUMP, ("series",))
    assert [("series40" in loop["kernel"], loop["instructions"]) for loop in both] == [
        (True, 5), (False, 2)]
    assert sass_count.parse_loops(DUMP, ("w40_window",)) == []


NESTED = """
	Function : _ZN3foo8series40ILb0EEEvPKf
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;                /* 0x00 */
        /*0010*/                   LDG.E R4, desc[UR4][R2.64] ;           /* 0x00 */
        /*0020*/                   LDG.E R5, desc[UR4][R2.64+0x4] ;       /* 0x00 */
        /*0030*/                   LDS.128 R8, [R7] ;                     /* 0x00 */
        /*0040*/                   FMUL R4, R4, R8 ;                      /* 0x00 */
        /*0050*/                   FMUL R5, R5, R9 ;                      /* 0x00 */
        /*0060*/                   SHF.R.U32.HI R6, RZ, 0x8, R4 ;         /* 0x00 */
        /*0070*/              @P0  BRA 0x10 ;                             /* 0x00 */
        /*0080*/                   LDG.E R4, desc[UR4][R2.64] ;           /* 0x00 */
        /*0090*/                   FMUL R4, R4, R8 ;                      /* 0x00 */
        /*00a0*/              @P1  BRA 0x80 ;                             /* 0x00 */
        /*00b0*/                   STG.E desc[UR4][R2.64], R4 ;           /* 0x00 */
        /*00c0*/              @P2  BRA 0x0 ;                              /* 0x00 */
        /*00d0*/                   EXIT ;                                 /* 0x00 */
"""


def test_instructions_per_step_is_the_largest_innermost_loop_over_its_global_loads():
    loops = sass_count.parse_loops(NESTED, ("series40",))
    assert [(lp["instructions"], lp["global_loads"], lp["innermost"]) for lp in loops] == [
        (7, 2, True), (3, 1, True), (13, 3, False)]
    assert sass_count.instructions_per_step(loops, "series40ILb0EE") == 3.5
    assert sass_count.instructions_per_step(loops, "series40ILb1EE") is None
    assert sass_count.instructions_per_step(
        sass_count.parse_loops(DUMP, ("seriesf",)), "seriesf") is None  # no global load
