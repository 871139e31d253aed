"""The port's copy of the reference's HLO collective parser
(``repro_torch.roofline.analysis.collective_bytes_from_hlo``) gives the
reference's dict, key for key, on HLO modules that reach each of its
paths: trip counts of (nested) while loops, tuple-shaped collectives,
``-start`` / ``-done`` pairs, calls, a module with no ENTRY (the flat sum)
and a dtype outside the table."""
import pytest

from repro.roofline.analysis import collective_bytes_from_hlo as ref_parse
from repro_torch.roofline.analysis import collective_bytes_from_hlo

REFERENCE_TEST = """
HloModule test

%body.1 (arg: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %ag = f32[4,8]{1,0} all-gather(%x), dimensions={0}
  %ar = f32[4,8]{1,0} all-reduce(%ag), to_apply=%add.1
}

%cond.1 (arg: (s32[], f32[4,8])) -> pred[] {
  %c = s32[] constant(10)
  %cmp = pred[] compare(%i, %c), direction=LT
}

ENTRY %main.9 (p: f32[4,8]) -> f32[4,8] {
  %w = (s32[], f32[4,8]) while(%init), condition=%cond.1, body=%body.1
  %ar2 = f32[16,16]{1,0} all-reduce(%y), to_apply=%add.1
}
"""

NESTED_WHILES = """
HloModule nested

%inner_body (a: (s32[], bf16[8,128])) -> (s32[], bf16[8,128]) {
  %rs = bf16[8,128]{1,0} reduce-scatter(%x), dimensions={0}, to_apply=%add
  %cp = bf16[8,128]{1,0} collective-permute(%x), source_target_pairs={{0,1}}
}

%inner_cond (a: (s32[], bf16[8,128])) -> pred[] {
  %n = s32[] constant(4)
  %lt = pred[] compare(%i, %n), direction=LT
}

%outer_body (a: (s32[], bf16[8,128])) -> (s32[], bf16[8,128]) {
  %w2 = (s32[], bf16[8,128]) while(%t), condition=%inner_cond, body=%inner_body
  %a2a = s32[64]{0} all-to-all(%y), dimensions={0}
}

%outer_cond (a: (s32[], bf16[8,128])) -> pred[] {
  %m = s32[] constant(3)
  %lt2 = pred[] compare(%i, %m), direction=LT
}

ENTRY %main.1 (p: bf16[8,128]) -> bf16[8,128] {
  %w1 = (s32[], bf16[8,128]) while(%init), condition=%outer_cond, body=%outer_body
  %ag = u8[1024]{0} all-gather(%z), dimensions={0}
}
"""

TUPLES_AND_ASYNC = """
HloModule tuples

%fused_comp (x: f32[2,2]) -> f32[2,2] {
  %ar.in = f32[2,2]{1,0} all-reduce(%x), to_apply=%add
}

ENTRY %main.7 (p: f32[4]) -> f32[4] {
  %t = (f32[4]{0}, bf16[16,2]{1,0}) all-reduce(%a, %b), to_apply=%add
  %s = (f32[32]{0}, f32[64]{0}) all-gather-start(%c), dimensions={0}
  %d = f32[64]{0} all-gather-done(%s)
  %cps = f32[10]{0} collective-permute-start(%e), source_target_pairs={{0,1}}
  %cpd = f32[10]{0} collective-permute-done(%cps)
  %f = f32[2,2]{1,0} fusion(%g), kind=kLoop, calls=%fused_comp
}
"""

NO_ENTRY = """
HloModule flat

%comp.a (x: f32[8]) -> f32[8] {
  %ar = f32[8]{0} all-reduce(%x), to_apply=%add
  %ag = s64[3,3]{1,0} all-gather(%y), dimensions={0}
}

%comp.b (x: f32[8]) -> f32[8] {
  %w = (s32[], f32[8]) while(%i), condition=%cond.b, body=%comp.a
  %rs = f16[6]{0} reduce-scatter(%x), dimensions={0}, to_apply=%add
}

%cond.b (x: (s32[], f32[8])) -> pred[] {
  %c = s32[] constant(7)
}
"""

UNKNOWN_DTYPE = """
HloModule odd

ENTRY %main.3 (p: f32[4]) -> f32[4] {
  %a = f8e4m3fn[16,16]{1,0} all-reduce(%x), to_apply=%add
  %b = (f8e5m2[4]{0}, f32[4]{0}) all-reduce(%y, %z), to_apply=%add
  %c = c64[2]{0} all-to-all(%w), dimensions={0}
  %d = pred[] all-reduce(%v), to_apply=%or
}
"""

MODULES = {"reference_test": REFERENCE_TEST, "nested_whiles": NESTED_WHILES,
           "tuples_and_async": TUPLES_AND_ASYNC, "no_entry": NO_ENTRY,
           "unknown_dtype": UNKNOWN_DTYPE, "empty": ""}


@pytest.mark.parametrize("name", list(MODULES))
def test_parser_gives_the_reference_dict(name):
    assert collective_bytes_from_hlo(MODULES[name]) == ref_parse(MODULES[name])


def test_parser_counts():
    """The figures themselves, worked by hand, so that the two copies do
    not agree on a wrong answer."""
    out = collective_bytes_from_hlo(REFERENCE_TEST)
    assert out["per_op_bytes"] == {"all-gather": 10 * 128,
                                   "all-reduce": 10 * 128 + 1024}
    assert out["entry"].startswith("main")
    nested = collective_bytes_from_hlo(NESTED_WHILES)
    assert nested["per_op_bytes"] == {
        "reduce-scatter": 3 * 4 * 2048, "collective-permute": 3 * 4 * 2048,
        "all-to-all": 3 * 256, "all-gather": 1024}
    tup = collective_bytes_from_hlo(TUPLES_AND_ASYNC)
    assert tup["per_op_bytes"]["all-reduce"] == 16 + 64 + 16
    assert tup["per_op_bytes"]["all-gather"] == 128 + 256
    assert tup["per_op_bytes"]["collective-permute"] == 40
    assert collective_bytes_from_hlo(NO_ENTRY)["entry"] == "flat"
