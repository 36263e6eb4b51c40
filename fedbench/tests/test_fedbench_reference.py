"""The plain reference against the system's CPU path at a tiny size: the
models' losses, LoRA's effective weights, AdamW, the int8 block codec,
its error feedback over rounds and the weighted mean.  (The test imports the port; the reference does not.)"""
from __future__ import annotations

import copy

import torch

from fedbench import harness
from fedbench.reference import common, femnist_cnn, olmo
from fedbench.reference.common import Precision, build, leaves


def f32(tree):
    return build([(k, t.float()) for k, t in leaves(tree)], tree)


def test_olmo_loss_matches_the_system(tiny):
    spec = tiny("olmo-1b.fedavg-bf16")
    cfg = dict(spec["config"], param_dtype="float32", compute_dtype="float32")
    fam = harness.load_module("families", "olmo")
    p = fam.make_params(cfg, spec["traffic"], 5, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (2, spec["traffic"]["context"]))
    labels = torch.randint(0, cfg["vocab_size"], toks.shape)
    loss_fn, _ = fam.program_fns(cfg, spec["traffic"])
    want = loss_fn(p, (toks, labels))
    got = olmo.loss(f32(p), (toks, labels), cfg, Precision())
    assert torch.allclose(got, want, rtol=1e-5)


def test_lora_effective_weights_match_the_system(tiny):
    spec = tiny("olmo-1b.lora8-int8")
    cfg = dict(spec["config"], param_dtype="float32", compute_dtype="float32")
    fam = harness.load_module("families", "olmo")
    p = fam.make_params(cfg, spec["traffic"], 6, "cpu")
    for name in spec["traffic"]["adapters"]["targets"]:       # move b off zero
        b = p["layers"]["attn"][f"{name}.lora_b"]
        b.copy_(torch.randn(b.shape) * 0.05)
    toks = torch.randint(0, cfg["vocab_size"], (2, spec["traffic"]["context"]))
    loss_fn, _ = fam.program_fns(cfg, spec["traffic"])
    want = loss_fn(p, (toks, toks))
    got = olmo.loss(f32(p), (toks, toks), cfg, Precision(), spec["traffic"]["adapters"])
    assert torch.allclose(got, want, rtol=1e-5)
    assert not torch.allclose(got, olmo.loss(f32(p), (toks, toks), cfg, Precision()), rtol=1e-5)


def test_femnist_loss_matches_the_system(tiny):
    spec = tiny("femnist-cnn.int8-async")
    fam = harness.load_module("families", "femnist_cnn")
    p = fam.make_params(spec["config"], spec["traffic"], 7, "cpu")
    x, y = next(fam.make_silos(spec["config"], spec["traffic"], 7, "cpu")[0].batches(16))
    loss_fn, _ = fam.program_fns(spec["config"], spec["traffic"])
    assert torch.allclose(femnist_cnn.loss(p, (x, y), spec["config"], Precision()),
                          loss_fn(p, (x, y)), rtol=1e-6)


def test_adamw_rule_matches_the_system():
    from repro_torch.optim import AdamW

    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(300, generator=g).to(torch.bfloat16), "b": torch.randn(7, 5, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p.items()} for _ in range(3)]
    sys_opt = AdamW(learning_rate=3e-4)
    ref = common.AdamW(3e-4)
    sp, state = p, sys_opt.init(p)
    rp = copy.deepcopy(p)
    m = {k: torch.zeros(v.shape) for k, v in p.items()}
    v = {k: torch.zeros(t.shape) for k, t in p.items()}
    for step, gr in enumerate(grads, 1):
        sp, state = sys_opt.update(gr, state, sp)
        for k in p:
            rp[k], m[k], v[k] = ref.step(rp[k], gr[k], m[k], v[k], step)
    for k in p:
        assert torch.equal(sp[k], rp[k]) and sp[k].dtype == p[k].dtype
        assert torch.equal(state.m[k], m[k]) and torch.equal(state.v[k], v[k])


def test_int8_codec_matches_the_system():
    from repro_torch.federated.compression import compress, decompress, parse_compression

    g = torch.Generator().manual_seed(1)
    vec = torch.randn(3 * common.QBLOCK + 77, generator=g) * 1e-3
    vec[common.QBLOCK:2 * common.QBLOCK] = 0.0          # an all-zero block
    want = decompress(compress(vec, parse_compression("int8")))
    assert torch.equal(common.block_roundtrip(vec), want)


def test_error_feedback_over_two_rounds_matches_the_system():
    from repro_torch.federated.compression import ClientCompressor, decompress, parse_compression

    from fedbench.reference.fedavg import fold_rounds

    g = torch.Generator().manual_seed(3)
    Q, silos = common.QBLOCK, [("a", 796), ("b", 860)]
    codecs = {cid: ClientCompressor(parse_compression("int8")) for cid, _ in silos}
    base, rounds, want = torch.randn(2 * Q, generator=g), [], []
    for _ in range(2):
        local = {cid: base + 1e-3 * torch.randn(2 * Q, generator=g) for cid, _ in silos}
        acc = torch.zeros(2 * Q)
        for cid, n in silos:
            acc.add_(decompress(codecs[cid].encode({"w": base}, {"w": local[cid]})), alpha=n)
        rounds.append({"base": base.view(2, Q), "dtype": torch.float32,
                       "silos": [(cid, n, local[cid].view(2, Q)) for cid, n in silos]})
        base = base + acc / sum(n for _, n in silos)
        want.append(base.view(2, Q))
    got = fold_rounds(rounds, "int8")
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
    assert not torch.allclose(fold_rounds(rounds, "int8", error_feedback=False)[1], want[1],
                              rtol=0, atol=1e-6)


def test_blocks_are_slices_of_the_flat_trained_leaves(tiny):
    spec = tiny("olmo-1b.lora8-int8")
    fam = harness.load_module("families", "olmo")
    p = fam.make_params(spec["config"], spec["traffic"], 7, "cpu")
    p = build([(k, torch.randn(t.shape).to(t.dtype)) for k, t in leaves(p)], p)
    blocks = harness.Blocks(p, spec["traffic"], 7)
    vec = common.flat([t for k, t in leaves(p) if ".lora_" in k[-1]])
    got = blocks(p)
    assert got.shape[1] == common.QBLOCK
    flat_got = got.reshape(-1)[blocks.valid]
    assert torch.equal(flat_got, vec[blocks.pos])
    assert blocks.pos[0] == 0 and blocks.pos[-1] == vec.numel() - 1


def test_weighted_mean_matches_the_system_fold():
    from repro_torch.federated.agg_engine import AggregationEngine

    g = torch.Generator().manual_seed(2)
    trees = [{"w": torch.randn(40, 3, generator=g), "b": torch.randn(9, generator=g)} for _ in range(3)]
    n = [796, 860, 924]
    want = AggregationEngine().aggregate(trees, n)
    for k in ("w", "b"):
        acc = torch.zeros_like(trees[0][k])
        for t, w in zip(trees, n):
            acc.add_(t[k], alpha=w / sum(n))
        assert torch.allclose(acc, want[k], rtol=1e-6, atol=1e-7)


def test_controls_round_their_operands():
    x = torch.randn(1000)
    tf32 = Precision("tf32").q(x)
    assert torch.equal(tf32.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    assert 0 < (tf32 - x).abs().max() <= x.abs().max() * 2 ** -11
    fp8 = Precision("fp8").q(x)
    assert len(torch.unique(fp8)) < 260 and (fp8 - x).abs().max() > 1e-3
