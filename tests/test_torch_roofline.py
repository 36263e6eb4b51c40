"""The port's roofline module: ``analysis.py`` (copied from the reference,
which imports no JAX) against the reference's on the same HLO text and
counts, and ``roofline()``'s three terms against their formula over the
H100 table in ``repro_torch/roofline/hardware.py``."""
import inspect

import pytest

from repro.roofline import analysis as jax_analysis
from repro_torch.roofline import hardware, model_flops_estimate, parse_collectives, roofline

HLO = {
    "every_kind": """
  %ag = bf16[16,512]{1,0} all-gather(bf16[1,512]{1,0} %p), dimensions={0}
  %ar.1 = f32[4096]{0} all-reduce(f32[4096]{0} %x), to_apply=%sum
  %rs = f32[256,8]{1,0} reduce-scatter(f32[4096,8]{1,0} %y), dimensions={0}
  %a2a = s8[64,64]{1,0} all-to-all(s8[64,64]{1,0} %z), dimensions={1}
  %cp = u16[3,5,7]{2,1,0} collective-permute(u16[3,5,7]{2,1,0} %w), source_target_pairs={{0,1}}
""",
    "async_pairs": """
  %ags = (bf16[8,128]{1,0}, bf16[64,128]{1,0}) all-gather-start(bf16[8,128]{1,0} %a)
  %agd = bf16[64,128]{1,0} all-gather-done((bf16[8,128]{1,0}, bf16[64,128]{1,0}) %ags)
  %ars = f32[1024]{0} all-reduce-start(f32[1024]{0} %b), to_apply=%add
  %ard = f32[1024]{0} all-reduce-done(f32[1024]{0} %ars)
  %cps = (f32[2,2]{1,0}, f32[2,2]{1,0}, u32[]) collective-permute-start(f32[2,2]{1,0} %c)
  %cpd = f32[2,2]{1,0} collective-permute-done((f32[2,2]{1,0}, f32[2,2]{1,0}, u32[]) %cps)
""",
    "tuples_and_scalars": """
  %t = (f32[16]{0}, s32[4,4]{1,0}, pred[]) all-reduce(f32[16]{0} %a, s32[4,4]{1,0} %b, pred[] %c)
  %u = (f64[2,3]{1,0}, c64[5]{0}, u4[8]{0}) all-gather(f64[1,3]{1,0} %d, c64[1]{0} %e, u4[1]{0} %f)
  %s = f32[] all-reduce(f32[] %g), to_apply=%add
  %n = f32[8]{0} add(f32[8]{0} %x, f32[8]{0} %y)
""",
    "none": "  %n = f32[8]{0} add(f32[8]{0} %x, f32[8]{0} %y)\n",
}


@pytest.mark.parametrize("name", sorted(HLO))
def test_parse_collectives_matches_reference(name):
    got, want = parse_collectives(HLO[name]), jax_analysis.parse_collectives(HLO[name])
    assert got.counts == want.counts
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.total_bytes == want.total_bytes


def test_parse_collectives_counts_async_pairs_once():
    got = parse_collectives(HLO["async_pairs"])
    assert got.counts["all-gather"] == 1 and got.counts["all-reduce"] == 1
    assert got.counts["collective-permute"] == 1
    assert got.bytes_by_kind["all-reduce"] == 2 * 1024 * 4      # a ring: twice the buffer


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,tokens", [(1_176_764_416, 4 * 2048), (128_983_488, 1), (7, 3)])
def test_model_flops_estimate_matches_reference(kind, n, tokens):
    assert model_flops_estimate(n, tokens, kind) == jax_analysis.model_flops_estimate(n, tokens, kind)


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_terms_over_the_h100_table(chips):
    cost = {"flops": 3.7e15, "bytes accessed": 2.9e12}
    rep = roofline("olmo-1b", "train_4k", "data=4", chips, cost, HLO["every_kind"],
                   model_flops=2.0e15, peak_memory_per_chip=6e10)
    coll = parse_collectives(HLO["every_kind"]).total_bytes
    assert rep.compute_s == 3.7e15 / (chips * 989e12)
    assert rep.memory_s == 2.9e12 / (chips * 3.35e12)
    assert rep.collective_s == coll / 450e9
    assert rep.dominant == max(("compute", rep.compute_s), ("memory", rep.memory_s),
                               ("collective", rep.collective_s), key=lambda t: t[1])[0]
    assert rep.useful_ratio == 2.0e15 / 3.7e15
    assert rep.to_row()["chips"] == chips and rep.to_row()["collective_bytes"] == coll
    # the same report's fields as the reference builds them, but its denominators
    want = jax_analysis.roofline("olmo-1b", "train_4k", "data=4", chips, cost, HLO["every_kind"],
                                 model_flops=2.0e15, peak_memory_per_chip=6e10)
    for key in ("arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes", "collective_bytes",
                "model_flops", "useful_ratio", "peak_memory_per_chip"):
        assert rep.to_row()[key] == want.to_row()[key], key


def test_h100_table_holds_the_data_sheet_numbers_and_no_tpu_constant():
    assert hardware.PEAK_FLOPS_BF16 == 989e12
    assert hardware.PEAK_FLOPS_TF32 == 495e12
    assert hardware.PEAK_FLOPS_FP32 == 67e12
    assert hardware.HBM_BANDWIDTH == 3.35e12
    assert hardware.HBM_BYTES == 80e9
    assert hardware.HBM_BYTES_VISIBLE == 79.18 * 2**30   # 85.0e9 B: the "80 GB" is 80 GiB
    assert hardware.ICI_LINK_BANDWIDTH == 450e9
    assert hardware.SMEM_BYTES_PER_SM == 228 * 1024
    assert not hasattr(hardware, "VMEM_BYTES")
    assert "https://www.nvidia.com/en-us/data-center/h100/" in inspect.getsource(hardware)
