"""tools/sass_loops.py's reading of `cuobjdump -sass` output, on a made-up
listing: the kernel label from the mangled name, the innermost loops (the
ranges closed by a backward branch holding no other), and each loop's
instruction classes.  The tool itself needs the CUDA toolkit and runs on
the card's machine (tests/test_torch_cuda.py)."""

from toypathtracer_torch.tools import sass_loops

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113render_kernelILi0EEEvPKfN3tpt12RenderParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;       /* 0x0 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x1, PT ;
        /*0020*/                   LDS R2, [R3] ;
        /*0030*/                   FADD R4, R2, -R5 ;
        /*0040*/                   MUFU.RSQ R6, R4 ;
        /*0050*/                   IADD3 R3, R3, 0x4, RZ ;
        /*0060*/               @P0 BRA 0x20 ;
        /*0070*/                   LDS.128 R8, [R3] ;
        /*0080*/                   FFMA R9, R8, R8, R9 ;
        /*0090*/              @!P1 BRA 0x70 ;
        /*00a0*/                   CALL.REL.NOINC 0x200 ;
        /*00b0*/                   BRA 0x10 ;
        /*00c0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_120merged_render_kernelILb1EEEvPKf
        /*0000*/                   EXIT ;
"""


def test_functions_are_labelled_by_kernel_and_template():
    funcs = sass_loops.functions(LISTING)
    assert sorted(funcs) == ["merged_render_kernel<1>", "render_kernel<0>"]
    code = funcs["render_kernel<0>"]
    assert code[0] == (0, "MOV R1, c[0x0][0x28]") and len(code) == 13


def test_innermost_loops_and_their_mix():
    code = sass_loops.functions(LISTING)["render_kernel<0>"]
    # 0x10-0xb0 holds both others: only the two inner loops count
    assert sass_loops.innermost_loops(code) == [(0x20, 0x60), (0x70, 0x90)]
    hit = sass_loops.loop_mix(code, 0x20, 0x60)
    assert hit["instructions"] == 5
    assert hit["by_class"] == {"fp32": 2, "lds": 1, "ld_generic": 0,
                               "ld_global": 0, "ld_const": 0, "int": 1,
                               "branch": 1, "other": 0}
    assert hit["mufu"] == {"MUFU.RSQ": 1} and hit["calls"] == 0
    assert hit["opcodes"] == ["LDS", "FADD", "MUFU.RSQ", "IADD3", "BRA"]
    assert sass_loops.loop_mix(code, 0x70, 0x90)["by_class"]["lds"] == 1


def test_opcode_drops_predicates():
    assert sass_loops.opcode("@!P1 BRA 0x70") == "BRA"
    assert sass_loops.classify("IMAD.WIDE.U32") == "int"
    assert sass_loops.classify("SHFL.IDX") == "other"


def test_sass_diff_pairs_renamed_kernels():
    """--compare's verdicts: a kernel that became a template (here
    "render_kernel<0>", there a plain "render_kernel") is compared under
    its old name when --same pairs them, and the rest by label."""
    here = sass_loops.functions(LISTING)
    code = here["render_kernel<0>"]
    there = {"render_kernel": list(code),
             "merged_render_kernel<1>": [(0, "NOP")],
             "old_kernel": [(0, "EXIT")]}
    d = sass_loops.sass_diff(here, there,
                             {"render_kernel<0>": "render_kernel"})
    assert d == {"identical": ["render_kernel<0>"],
                 "differ": ["merged_render_kernel<1>"],
                 "parameter_offsets_only": [],
                 "only_here": [], "only_there": ["old_kernel"]}
    plain = sass_loops.sass_diff(here, there)
    assert plain["only_here"] == ["render_kernel<0>"]
    assert "render_kernel" in plain["only_there"] and there.keys() == {
        "render_kernel", "merged_render_kernel<1>", "old_kernel"}


def test_sass_diff_tells_parameter_offsets_apart():
    """A kernel whose SASS differs only in the parameter bank's offsets
    (c[0x0][0x...]: a struct argument grew) is listed as differing and as
    differing in parameter offsets only; one whose instructions differ
    is not."""
    here = {"a": [(0, "LDC R1, c[0x0][0x210]"), (16, "FADD R2, R1, R1")],
            "b": [(0, "LDC R1, c[0x0][0x210]"), (16, "FMUL R2, R1, R1")]}
    there = {"a": [(0, "LDC R1, c[0x0][0x214]"), (16, "FADD R2, R1, R1")],
             "b": [(0, "LDC R1, c[0x0][0x214]"), (16, "FADD R2, R1, R1")]}
    d = sass_loops.sass_diff(here, there)
    assert d["differ"] == ["a", "b"]
    assert d["parameter_offsets_only"] == ["a"]


def test_digests_equal_exactly_where_sass_diff_says_identical():
    """--digests (chip_smoke.py's KEPT_SASS): a kernel's digest changes with
    any instruction or address and with nothing else, so two libraries'
    digests agree exactly for the kernels sass_diff calls identical."""
    here = sass_loops.functions(LISTING)
    moved = {k: [(a + 16, t) for a, t in v] for k, v in here.items()}
    edited = {k: list(v) for k, v in here.items()}
    edited["render_kernel<0>"][3] = (0x30, "FMUL R4, R2, -R5")
    d0 = sass_loops.digests(here)
    assert d0 == sass_loops.digests({k: list(v) for k, v in here.items()})
    assert sorted(d0) == sorted(here) and all(len(v) == 64
                                              for v in d0.values())
    for other in (moved, edited):
        d1 = sass_loops.digests(other)
        same = sass_loops.sass_diff(here, other)["identical"]
        assert [k for k in sorted(d0) if d0[k] == d1[k]] == same
    assert sass_loops.sass_diff(here, edited)["identical"] == [
        "merged_render_kernel<1>"]
