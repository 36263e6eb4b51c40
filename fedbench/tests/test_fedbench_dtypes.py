"""The fold check over trees whose trained leaves mix dtypes: ``Blocks``
records each sampled element's stored dtype, ``FoldProbe`` keeps it in
each round's record, and ``fold_rounds`` rounds each element of a result
to its own leaf's dtype; with one dtype everything is as it was."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from fedbench import harness
from fedbench.reference import common
from fedbench.reference.common import DTYPES, QBLOCK, dtype_code, flat, leaves
from fedbench.reference.fedavg import fold_rounds

BF16, F32 = dtype_code(torch.bfloat16), dtype_code(torch.float32)


def mixed_tree(seed=0, big=3 * QBLOCK + 100):
    """bfloat16 projections around float32 vectors, in sorted-key order:
    ``a`` (bf16), ``b`` (fp32), ``c.d`` (bf16), ``c.e`` (fp32)."""
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(big, generator=g).to(torch.bfloat16),
            "b": torch.randn(700, generator=g),
            "c": {"d": torch.randn(40, 90, generator=g).to(torch.bfloat16),
                  "e": torch.randn(33, generator=g)}}


def leaf_codes(tree):
    """Each flat element's dtype code, in sorted-key order."""
    return torch.cat([torch.full((t.numel(),), dtype_code(t.dtype), dtype=torch.int8)
                      for _, t in leaves(tree)])


def parent_positions(n, seed):
    """The sampled positions as a tree of one dtype has always drawn them."""
    nb = -(-n // QBLOCK)
    g = torch.Generator().manual_seed(seed % 2 ** 63)
    drawn = torch.randperm(nb, generator=g)[:harness.FOLD_BLOCKS]
    blocks = torch.cat([drawn, torch.tensor([0, nb - 1])]).unique()
    pos = (blocks[:, None] * QBLOCK + torch.arange(QBLOCK)[None, :]).reshape(-1)
    return pos[pos < n]


def test_blocks_record_each_elements_leaf_dtype():
    p = mixed_tree()
    blocks = harness.Blocks(p, {}, 5)
    got = blocks(p)
    assert blocks.codes.shape == got.shape and blocks.codes.dtype == torch.int8
    assert torch.equal(got.reshape(-1)[blocks.valid], flat([t for _, t in leaves(p)])[blocks.pos])
    assert torch.equal(blocks.codes.reshape(-1)[blocks.valid], leaf_codes(p)[blocks.pos])
    assert set(blocks.codes.reshape(-1)[blocks.valid].tolist()) == {BF16, F32}
    assert not blocks.codes.reshape(-1)[~blocks.valid].any()    # padding: float32's code


@pytest.mark.parametrize("seed", [1, 2, 3, 2 ** 40 + 7])
def test_every_leaf_of_a_minority_dtype_is_sampled(seed, monkeypatch):
    """Two blocks drawn of ten: the float32 leaves' first and last
    blocks are always among them, so a fold that rounds them is seen."""
    monkeypatch.setattr(harness, "FOLD_BLOCKS", 2)
    p = {"a": torch.zeros(4 * QBLOCK, dtype=torch.bfloat16), "b": torch.zeros(QBLOCK + 9),
         "c": torch.zeros(4 * QBLOCK, dtype=torch.bfloat16), "d": torch.zeros(5)}
    blocks = harness.Blocks(p, {}, seed)
    sampled = set((blocks.pos // QBLOCK).tolist())
    assert {4, 5, 9} <= sampled
    codes = blocks.codes.reshape(-1)[blocks.valid]
    assert int((codes == F32).sum()) == QBLOCK + 9 + 5


@pytest.mark.parametrize("seed", [4, 2 ** 33 + 1])
def test_a_tree_of_one_dtype_samples_as_before(seed, tiny):
    spec = tiny("olmo-1b.fedavg-bf16")
    fam = harness.load_module("families", "olmo")
    p = fam.make_params(spec["config"], spec["traffic"], seed, "cpu")
    blocks = harness.Blocks(p, spec["traffic"], seed)
    assert torch.equal(blocks.pos, parent_positions(sum(t.numel() for _, t in leaves(p)), seed))
    assert set(blocks.codes.unique().tolist()) <= {BF16, F32}
    assert torch.equal(blocks.codes.reshape(-1)[blocks.valid],
                       torch.full((blocks.pos.numel(),), BF16, dtype=torch.int8))


def test_fold_probe_keeps_the_codes_of_each_round():
    p = mixed_tree()
    blocks = harness.Blocks(p, {}, 3)
    silo = SimpleNamespace(client_id="a", n_samples=4, params=p)
    server = SimpleNamespace(params=p, _fold_phase=lambda r, res: SimpleNamespace(params=p))
    probe = harness.FoldProbe(server, blocks)
    server._fold_phase(1, [silo])
    probe.remove()
    (rnd,) = probe.rounds
    assert rnd["dtype"] is blocks.codes
    assert torch.equal(rnd["new"], blocks(p)) and rnd["silos"][0][:2] == ("a", 4)


def _rounds(codes, seed=0, n_rounds=2):
    """Rounds over the given codes: float32 weights and silos a little
    apart, as the harness records them."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(codes.shape, generator=g)
    out = []
    for _ in range(n_rounds):
        silos = [(c, n, base + 1e-2 * torch.randn(codes.shape, generator=g))
                 for c, n in (("a", 796), ("b", 860), ("c", 924))]
        out.append({"base": base, "dtype": codes, "silos": silos})
        base = base + 1e-2 * torch.randn(codes.shape, generator=g)
    return out


def _mixed_codes():
    codes = torch.full((3, QBLOCK), BF16, dtype=torch.int8)
    codes[0, 100:900] = F32
    codes[2, -50:] = F32
    return codes


@pytest.mark.parametrize("update", ["dense", "int8"])
def test_fold_rounds_rounds_each_element_to_its_leaf_dtype(update):
    codes = _mixed_codes()
    rounds = _rounds(codes)
    got = fold_rounds(rounds, update)
    exact = fold_rounds([dict(r, dtype=torch.float32) for r in rounds], update)
    as_bf16 = fold_rounds([dict(r, dtype=torch.bfloat16) for r in rounds], update)
    f32 = codes == F32
    for g, e, b in zip(got, exact, as_bf16):
        assert torch.equal(g[f32], e[f32]) and torch.equal(g[~f32], b[~f32])
        assert not torch.equal(g[f32], b[f32])          # float32 elements were not rounded


@pytest.mark.parametrize("update", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_dtype_is_bit_equal_to_the_whole_result_cast(update, dtype):
    codes = torch.full((3, QBLOCK), dtype_code(dtype), dtype=torch.int8)
    rounds = _rounds(codes, seed=1)
    got = fold_rounds(rounds, update)
    whole = fold_rounds([dict(r, dtype=dtype) for r in rounds], update)
    unrounded = fold_rounds([dict(r, dtype=torch.float64) for r in rounds], update)
    for g, w, u in zip(got, whole, unrounded):
        assert torch.equal(g, w) and torch.equal(g, u.to(dtype).float())


def test_round_stored_knows_every_code():
    x = torch.randn(len(DTYPES), 64)
    codes = torch.arange(len(DTYPES), dtype=torch.int8)[:, None].expand(-1, 64)
    got = common.round_stored(x, codes)
    for i, dt in enumerate(DTYPES):
        assert torch.equal(got[i], x[i].to(dt).float())
    with pytest.raises(ValueError):
        dtype_code(torch.int32)


def test_the_ports_mamba2_and_moe_trees_pass_blocks():
    """The port's own trees mix dtypes: mamba2 keeps ``A_log``, ``D`` and
    ``dt_bias`` in float32 beside bfloat16 projections, an MoE layer its
    router.  ``Blocks`` takes both, with each element's leaf's code."""
    from repro_torch.configs.registry import GRANITE_MOE_1B, MAMBA2_130M
    from repro_torch.models.moe import init_moe
    from repro_torch.models.ssm_lm import init_ssm_lm

    trees = {"mamba2": init_ssm_lm(torch.Generator().manual_seed(0), MAMBA2_130M.reduced(),
                                   device="cpu"),
             "moe": init_moe(torch.Generator().manual_seed(0), GRANITE_MOE_1B.reduced(),
                             device="cpu")}
    for name, p in trees.items():
        assert {t.dtype for _, t in leaves(p)} == {torch.bfloat16, torch.float32}, name
        blocks = harness.Blocks(p, {}, 9)
        want = leaf_codes(p)[blocks.pos]
        assert torch.equal(blocks.codes.reshape(-1)[blocks.valid], want), name
        assert set(want.tolist()) == {BF16, F32}, name
        assert torch.equal(blocks(p).reshape(-1)[blocks.valid],
                           flat([t for _, t in leaves(p)])[blocks.pos]), name
