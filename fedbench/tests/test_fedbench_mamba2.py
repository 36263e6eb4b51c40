"""The ``mamba2`` family on the CPU at a small size (2 layers, d_model 64,
N 16, P 16, chunk 8, context 32): the plain reference's chunked SSD
against a sequential recurrence; the program's loss and gradients against
the reference's; the cell's check (a sound run is correct; the control
and each fault are not; a fold that rounds the float32 leaves to
bfloat16 reads over the ``fold`` limit); the SSD's work and FLOP counts
at the kernel table's shape and by hand; and the two SSD metrics on
synthetic records."""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from fedbench import harness
from fedbench.check import fold_gap, is_correct, readings, verdict
from fedbench.reference import mamba2 as ref
from fedbench.reference.common import Precision, build, leaves
from fedbench.reference.fedavg import fold_rounds

ROOT = Path(__file__).resolve().parents[2]
PEAKS = json.loads((ROOT / "fedbench/peaks.json").read_text())
CELL = "mamba2-130m.fedavg-bf16"


def small(fp32: bool = False) -> dict:
    """The cell's files at the small size; ``fp32`` runs the bfloat16
    configuration in float32 (at these widths bfloat16's rounding averages
    out over too few elements to stay under limits set at full width)."""
    spec = copy.deepcopy(harness.cell_spec(CELL))
    spec["config"].update(n_layer=2, d_model=64, d_state=16, headdim=16, chunk_size=8,
                          vocab_size=97)
    spec["traffic"].update(silos=[[16, 4], [16, 4]], context=32)
    if fp32:
        spec["config"].update(param_dtype="float32", compute_dtype="float32")
    return spec


def run_small(spec, seed=11):
    return harness.run("small", seed, 0.05, False, "cpu", spec, log=lambda s: None)


# ---------------------------------------------------------------------------
# The plain reference
# ---------------------------------------------------------------------------

def sequential_ssd(x, dt, A, Bm, Cm):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, in float64."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    Bsz, S, H, P = x.shape
    h = x.new_zeros(Bsz, H, P, Bm.shape[-1])
    ys = []
    for t in range(S):
        h = (h * torch.exp(dt[:, t] * A)[:, :, None, None]
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :])
        ys.append((h * Cm[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, dim=1)


def test_chunked_ssd_matches_a_sequential_recurrence():
    g = torch.Generator().manual_seed(3)
    Bsz, S, H, P, N, Q = 2, 32, 3, 4, 5, 8
    x = torch.randn(Bsz, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(Bsz, S, H, generator=g))
    A = -torch.linspace(0.5, 4.0, H)
    Bm, Cm = (torch.randn(Bsz, S, N, generator=g) for _ in range(2))
    want = sequential_ssd(x, dt, A, Bm, Cm)
    got = ref.ssd(x, dt, A, Bm, Cm, Q, Precision())
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_segsum_sums_the_steps_between():
    a = torch.tensor([1.0, 2.0, 4.0])
    inf = float("-inf")
    assert torch.equal(ref.segsum(a), torch.tensor([[0.0, inf, inf], [2.0, 0.0, inf],
                                                    [6.0, 4.0, 0.0]]))


class _Bf16(Precision):
    """Each product's operands rounded to bfloat16 (straight through)."""

    def q(self, x):
        return x + (x.detach().to(torch.bfloat16).float() - x.detach())


def _loss_and_grads(spec, prec=None, seed=5):
    cfg, traffic = spec["config"], spec["traffic"]
    fam = harness.load_module("families", "mamba2")
    p = fam.make_params(cfg, traffic, seed, "cpu")
    x, y = next(fam.make_silos(cfg, traffic, seed, "cpu")[0].batches(traffic["batch"]))
    pairs = [(k, t.detach().float().requires_grad_()) for k, t in leaves(p)]
    tree = build(pairs, p)
    if prec is None:
        loss = fam.program_fns(cfg, traffic)[0](tree, (x, y))
    else:
        loss = ref.loss(tree, (x, y), cfg, prec)
    return float(loss.detach()), torch.autograd.grad(loss, [t for _, t in pairs])


def test_program_loss_and_gradients_match_the_reference():
    """Tolerances: the two are the same float32 arithmetic in another order
    (the program's SSD subtracts cumulative sums and takes its decays in
    float64), so they agree to a few float32 roundings: 1e-6 on the loss,
    1e-4 of each gradient's norm.  A reference whose products take
    bfloat16 operands misses both by far."""
    spec = small(fp32=True)
    loss, grads = _loss_and_grads(spec)
    want_loss, want = _loss_and_grads(spec, Precision())
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    gaps = [float((g - w).norm() / w.norm()) for g, w in zip(grads, want) if w.norm() > 0]
    assert max(gaps) <= 1e-4
    bf_loss, bf = _loss_and_grads(spec, _Bf16())
    bf_gaps = [float((g - w).norm() / w.norm()) for g, w in zip(bf, want) if w.norm() > 0]
    assert abs(bf_loss - want_loss) > 1e-6 * abs(want_loss) and max(bf_gaps) > 1e-4


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def test_sound_small_run_is_correct():
    result = run_small(small(fp32=True))
    assert result["correct"] is True, result["checks"]


def test_control_is_not_correct():
    spec = small()
    dev = torch.device("cpu")
    fam = harness.load_module("families", "mamba2")
    for seed in (21, 22, 23):
        silos = fam.make_silos(spec["config"], spec["traffic"], seed, dev)
        base = harness.reference_round(spec, silos, seed, dev)
        ctl = harness.reference_round(spec, silos, seed, dev, "fp8")
        numbers = readings(ctl, base, harness.evaluated(spec, ctl["params1"], silos, dev))
        assert not is_correct(verdict(numbers, spec["limits"]))


def _state_unchanged(monkeypatch):
    from repro_torch.optim import optimizers

    step = optimizers.AdamW.update
    monkeypatch.setattr(optimizers.AdamW, "update",
                        lambda self, g, s, p: (p, step(self, g, s, p)[1]))


def _half_batch(monkeypatch):
    from repro_torch.models import api

    nll = api._nll
    monkeypatch.setattr(api, "_nll", lambda logits, y: nll(logits[: len(y) // 2], y[: len(y) // 2]))


def _tree_altered(monkeypatch, fn):
    """The fold's result passed through ``fn`` leaf by leaf where it is
    produced."""
    from repro_torch.federated import agg_engine
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    def altered(inner):
        def wrapped(*a, **kw):
            out, treedef = tree_flatten(inner(*a, **kw))
            return tree_unflatten(treedef, [fn(t) for t in out])
        return wrapped

    for cls, name in ((agg_engine.AggregationEngine, "aggregate"),
                      (agg_engine.StreamingAggregator, "result"),
                      (agg_engine.StructuredStreamingAggregator, "result")):
        monkeypatch.setattr(cls, name, altered(getattr(cls, name)))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": lambda mp: _tree_altered(mp, lambda t: t * 1.01)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_small(small(fp32=True))
    assert result["correct"] is False, result["checks"]


def test_float32_leaves_rounded_in_the_fold_are_caught(monkeypatch):
    """The bfloat16 tree keeps A_log, D and dt_bias in float32: a sound fold
    reads under the cell's ``fold`` limit, one that rounds those leaves to
    bfloat16 over it."""
    spec = small()
    limit = spec["limits"]["fold"]
    sound = run_small(spec)
    assert sound["checks"]["fold"]["value"] <= limit
    _tree_altered(monkeypatch, lambda t: t.to(torch.bfloat16).float()
                  if t.dtype == torch.float32 else t)
    planted = run_small(spec)
    assert planted["checks"]["fold"]["value"] > limit, planted["checks"]
    assert planted["correct"] is False


def test_fold_control_is_not_correct():
    spec = small()
    for seed in (21, 22):
        rounds = harness.first_round(spec, seed, torch.device("cpu"))["fold"]
        ctl = [dict(r, new=x) for r, x in zip(rounds, fold_rounds(rounds, "dense", "fp8"))]
        fold = fold_gap(ctl, fold_rounds(rounds, "dense"))
        assert not is_correct(verdict({"fold": fold}, {"fold": spec["limits"]["fold"]}))


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------

def test_full_size_parameter_count_and_dtypes():
    from fedbench.families.silos import spec_leaves

    cfg = harness.cell_spec(CELL)["config"]
    spec = harness.load_module("families", "mamba2").weight_spec(cfg, {})
    pairs = spec_leaves(spec)
    assert sum(torch.Size(s).numel() for _, (s, _, _) in pairs) == cfg["n_params"] == 128_989_632
    f32 = {path[-1] for path, (_, _, dt) in pairs if dt == torch.float32}
    assert f32 == {"A_log", "D", "dt_bias"}
    assert dict(pairs)[("embed", "embedding")][0] == (50_288, 768)


def test_ssd_work_gives_the_kernel_tables_bounds():
    """(4, 2048, 24 heads, 64), N 128, chunk 256: the forward's bound
    0.1004 ms (float32 operations), the backward's 0.0609 ms (3xTF32)."""
    shape = {"B": 4, "L": 2048, "H": 24, "P": 64, "N": 128, "chunk": 256, "itemsize": 2}
    least = {}
    for kernel in ("ssd_chunk_scan", "ssd_scan_bwd"):
        w = harness.load_module("work", kernel).work(**shape)
        least[kernel] = max(w["flops"] / PEAKS["flops_per_s"][w["rate"]],
                            w["bytes"] / PEAKS["hbm_bytes_per_s"]) * 1e3
    assert least["ssd_chunk_scan"] == pytest.approx(0.1004, rel=0.01)
    assert least["ssd_scan_bwd"] == pytest.approx(0.0609, rel=0.01)


def test_ssd_forward_work_counts_the_causal_products():
    """The forward's operations against the reference's products with the
    causal half taken by hand: C B^T and (L o G)(x dt) over s <= l, the
    states' product whole."""
    Bsz, S, H, P, N, Q = 2, 16, 3, 4, 5, 8
    C = S // Q
    w = harness.load_module("work", "ssd_chunk_scan").work(Bsz, S, H, P, N, Q, itemsize=4)
    pairs = Q * (Q + 1) // 2
    assert w["flops"] == (2 * (Bsz * C * pairs * N + Bsz * C * H * pairs * P)
                          + 2 * Bsz * C * H * P * N * Q)
    # x, B, C (float32 here) and dt read; y, the states and a_cs written.
    assert w["bytes"] == 4 * (Bsz * S * H * P + 2 * Bsz * S * N + Bsz * S * H
                              + Bsz * C * H * (Q * P + P * N + Q))


def test_round_flops_match_a_hand_count():
    spec = small()
    cfg, traffic = spec["config"], spec["traffic"]
    flops = harness.load_module("flops", "mamba2")
    E, N, P, Q, S = 128, 16, 16, 8, 32
    H = E // P
    per_token = H * ((Q + 1) * P + 4 * P * N) + (Q + 1) * N
    assert flops.ssd_flops_per_token(cfg) == per_token == 8 * (9 * 16 + 1024) + 144
    n = 1000
    one = dict(traffic, silos=[[4, 0]])
    assert flops.round_flops(cfg, one, n, n) == 4 * S * (6 * n + 3 * 2 * per_token)
    ev = dict(traffic, silos=[[0, 4]])
    assert flops.round_flops(cfg, ev, n, n) == 4 * S * (2 * n + 2 * per_token)


def test_reference_products_are_the_counted_ones():
    """``torch.utils.flop_counter`` on the reference's forward: every
    parameter's 2 a token in the products but the convolution's, norms' and
    SSD's small leaves, plus the SSD's products over whole Q x Q squares
    (the model FLOPs count their causal half)."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = small(fp32=True)
    cfg, traffic = spec["config"], spec["traffic"]
    fam = harness.load_module("families", "mamba2")
    p = fam.make_params(cfg, traffic, 0, "cpu")
    Bsz, S = 2, traffic["context"]
    toks = torch.randint(0, cfg["vocab_size"], (Bsz, S))
    with FlopCounterMode(display=False) as mode:
        ref.loss(p, (toks, toks), cfg, Precision())
    E, N, P, Q, L, V, D = 128, 16, 16, 8, 2, 112, 64
    H, C = E // P, S // Q
    proj = L * (D * (2 * E + 2 * N + H) + E * D) + V * D
    ssd = L * (Bsz * C * (2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * P * N)))
    assert mode.get_total_flops() == 2 * proj * Bsz * S + ssd


# ---------------------------------------------------------------------------
# The SSD metrics
# ---------------------------------------------------------------------------

def record(**over):
    shape = {"B": 4, "L": 2048, "H": 24, "P": 64, "N": 128, "chunk": 256, "itemsize": 2}
    rec = {"device": "cuda", "peaks": PEAKS,
           "trace": {"rounds": [{}, {}], "device_ops": {
               "void (anonymous namespace)::ssd_intra<__nv_bfloat16>(Args)": 0.2,
               "void (anonymous namespace)::bwd_heads<__nv_bfloat16>(Args)": 0.2,
               "void (anonymous namespace)::bwd_dA(Args)": 0.01,
               "void (anonymous namespace)::bwd_chunk<__nv_bfloat16>(Args)": 0.09,
               "flash_fwd_wgmma": 1.0, "ampere_sgemm": 1.0}},
           "work": {"ssd": {"shape": shape, "train_calls": 384, "eval_calls": 96}},
           "phases": {"rounds": 2, "span_idle_s": {"ssm.scan": 0.5, "ssm.scan.bwd": 0.1,
                                                   "fl.train": 3.0}}}
    rec.update(over)
    return rec


def read(name, rec):
    return harness.load_module("metrics", name).read(rec)


def test_ssd_roofline_reads_the_ssd_kernels():
    fwd = 4 * 8 * (24 * (256 * 257 * 64 + 2 * 64 * 128 * 256) + 256 * 257 * 128) / 67e12
    mm, pairs = 256 * 257, 2 * 256 * 128 * 64
    bwd = 4 * 8 * (24 * (5 * mm * 64 + 4 * pairs) + 4 * mm * 128) / 495e12
    least = 384 * (fwd + bwd) + 96 * fwd
    assert read("ssd.roofline", record()) == pytest.approx(100 * 2 * least / 0.5)


def test_idle_ssd_adds_the_forward_and_backward_spans():
    assert read("idle.ssd_s", record()) == pytest.approx((0.5 + 0.1) / 2)
    forward_only = record(phases={"rounds": 2, "span_idle_s": {"ssm.scan": 0.5}})
    assert read("idle.ssd_s", forward_only) == pytest.approx(0.25)


def test_ssd_metrics_are_silent_without_a_trace_a_kernel_or_a_card():
    assert read("ssd.roofline", record(trace=None)) is None
    no_kernel = record()
    no_kernel["trace"]["device_ops"] = {"ampere_sgemm": 1.0}
    assert read("ssd.roofline", no_kernel) is None
    assert read("ssd.roofline", record(work={})) is None
    assert read("ssd.roofline", record(device="cpu")) is None
    assert read("idle.ssd_s", record(phases=None)) is None
    other_spans = {"rounds": 2, "span_idle_s": {"fl.train": 1.0}}
    assert read("idle.ssd_s", record(phases=other_spans)) is None
    assert read("idle.ssd_s", record(device="cpu")) is None
