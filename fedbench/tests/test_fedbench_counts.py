"""``fedbench/flops/`` and ``fedbench/work/`` against
``torch.utils.flop_counter`` and shape counts on the plain models at
small sizes."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench import harness
from fedbench.families.silos import spec_leaves
from fedbench.reference import femnist_cnn as ref_cnn
from fedbench.reference import olmo as ref_olmo
from fedbench.reference.common import Precision, build, leaves


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def f32_params(spec, seed=0):
    fam = harness.load_module("families", spec["config"]["family"])
    p = fam.make_params(spec["config"], spec["traffic"], seed, "cpu")
    return build([(k, t.float().requires_grad_()) for k, t in leaves(p)], p)


def test_femnist_forward_and_round_flops(tiny):
    spec = tiny("femnist-cnn.dense-barrier")
    cfg, traffic = spec["config"], spec["traffic"]
    flops = harness.load_module("flops", "femnist_cnn")
    p = f32_params(spec)
    x = torch.randn(3, 28, 28, 1)
    fwd = counted(lambda: ref_cnn.logits(p, x, cfg, Precision()))
    assert fwd == 3 * flops.forward_flops(cfg)
    train = counted(lambda: ref_cnn.loss(p, (x, torch.zeros(3, dtype=torch.long)), cfg,
                                         Precision()).backward())
    # The first convolution takes no gradient for its input image.
    conv1_input_grad = 2 * 25 * 32 * 28 * 28 * 3
    assert train == 3 * fwd - conv1_input_grad
    n = sum(t.numel() for _, t in leaves(p))
    want = flops.forward_flops(cfg) * (3 * sum(a for a, _ in traffic["silos"])
                                       + sum(b for _, b in traffic["silos"]))
    assert flops.round_flops(cfg, traffic, n, n) == want


def test_femnist_paper_width_counts():
    flops = harness.load_module("flops", "femnist_cnn")
    cfg = harness.cell_spec("femnist-cnn.int8-async")["config"]
    fam = harness.load_module("families", "femnist_cnn")
    spec = fam.weight_spec(cfg, {})
    n = sum(torch.Size(s).numel() for _, (s, _, _) in spec_leaves(spec))
    assert n == cfg["n_params"] == 164_187_070
    assert flops.forward_flops(cfg) == 349_512_704


def test_olmo_round_flops_match_the_counted_products(tiny, monkeypatch):
    spec = tiny("olmo-1b.fedavg-bf16")
    cfg, traffic = spec["config"], spec["traffic"]
    flops = harness.load_module("flops", "olmo")
    p = f32_params(spec)
    B, S = 2, traffic["context"]
    toks = torch.randint(0, cfg["vocab_size"], (B, S))
    fwd = counted(lambda: ref_olmo.loss(p, (toks, toks), cfg, Precision()))
    n = sum(t.numel() for _, t in leaves(p))
    d, L = cfg["n_heads"] * cfg["head_dim"], cfg["n_layers"]
    # The plain reference forms the full square of scores; the model FLOPs
    # count the causal half: 2 S d a token and layer against 4 S d.
    assert fwd == 2 * n * B * S + 4 * S * d * L * B * S
    # Without the reference's recompute of each layer (no model FLOPs).
    monkeypatch.setattr(ref_olmo, "checkpoint", lambda f, *a, **kw: f(*a))
    train = counted(lambda: ref_olmo.loss(p, (toks, toks), cfg, Precision()).backward())
    assert train == 3 * fwd
    one = dict(traffic, silos=[[B, 0]])
    assert flops.round_flops(cfg, one, n, n) == 3 * (2 * n * B * S + 2 * S * d * L * B * S)
    ev = dict(traffic, silos=[[0, B]])
    assert flops.round_flops(cfg, ev, n, n) == 2 * n * B * S + 2 * S * d * L * B * S


def test_olmo_full_size_parameter_count():
    cfg = harness.cell_spec("olmo-1b.fedavg-bf16")["config"]
    spec = harness.load_module("families", "olmo").weight_spec(cfg, {})
    assert sum(torch.Size(s).numel() for _, (s, _, _) in spec_leaves(spec)) == cfg["n_params"]


def test_attention_work_counts_the_causal_half():
    work = harness.load_module("work", "flash_attention").work
    B, S, H, D = 2, 16, 3, 8
    q, k, v = (torch.randn(B, H, S, D) for _ in range(3))
    full = counted(lambda: torch.softmax(q @ k.transpose(-1, -2), -1) @ v)
    assert work(B, S, H, D, causal=False)["flops"] == full
    pairs = S * (S + 1) // 2                       # query-key pairs at or below the diagonal
    assert work(B, S, H, D)["flops"] == 2 * 2 * B * H * D * pairs
    assert work(B, S, H, D)["bytes"] == 4 * q.numel() * 2   # q, k, v, o in bf16
    bwd = harness.load_module("work", "flash_attention_bwd").work(B, S, H, D)
    assert bwd["flops"] == 2.5 * work(B, S, H, D)["flops"]
    assert bwd["bytes"] == 8 * q.numel() * 2     # q, k, v, o, do in; dq, dk, dv out


def test_fold_work_counts_each_byte_once():
    n, L = 4, 3 * 8192 + 5
    rows, out = torch.zeros(n, L), torch.zeros(L)
    w = harness.load_module("work", "fedavg_reduce").work(n, L)
    assert w["bytes"] == rows.nbytes + out.nbytes
    acc, codes = torch.zeros(L), torch.zeros(L, dtype=torch.int8)
    scales = torch.zeros(-(-L // 8192))
    d = harness.load_module("work", "dequant_fold").work(L, "int8")
    assert d["bytes"] == 2 * acc.nbytes + codes.nbytes + scales.nbytes
