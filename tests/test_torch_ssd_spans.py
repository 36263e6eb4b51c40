"""The SSD scan's spans and counter (``repro_torch.utils.spans``) on the
CPU: each Mamba-2 layer's forward scan is one ``ssm.scan`` span and adds
its B·L positions to ``ssm.scan.tokens``; the intra-chunk part's backward
is one ``ssm.scan.bwd`` span; off, nothing is recorded and the values are
those of a run with spans on."""
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import _SSDIntraChunkFn
from repro_torch.models import get_model
from repro_torch.utils import spans

CFG = ModelConfig(name="ssm-tiny", arch_type="ssm", n_layers=3, d_model=32, n_heads=0,
                  n_kv_heads=0, d_ff=0, vocab_size=64, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=8, dtype="float32", param_dtype="float32")
BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _model_and_batch():
    model = get_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, CFG.vocab_size, (BATCH, SEQ), generator=gen)
    return model, params, {"tokens": toks, "labels": toks}


def _names(taken):
    return [s.name for s in taken.spans]


@pytest.mark.parametrize("forwards", [1, 2])
def test_one_scan_span_a_layer_and_the_positions_counted(forwards):
    model, params, batch = _model_and_batch()
    spans.enable()
    with spans.span("fl.round", round=4):
        for _ in range(forwards):
            model.loss(params, batch)
    taken = spans.take()
    spans.disable()
    scans = [s for s in taken.spans if s.name == "ssm.scan"]
    assert len(scans) == forwards * CFG.n_layers
    assert all(s.round == 4 and s.end_ns >= s.start_ns for s in scans)
    assert taken.counters["ssm.scan.tokens"] == {4: forwards * BATCH * SEQ * CFG.n_layers}


def test_off_records_nothing_and_changes_no_value():
    model, params, batch = _model_and_batch()
    off = model.loss(params, batch)
    assert not spans.take().spans and not spans.take().counters
    spans.enable()
    on = model.loss(params, batch)
    spans.disable()
    assert torch.equal(off, on)
    assert set(_names(spans.take())) == {"ssm.scan"}


def _intra_inputs():
    g = torch.Generator().manual_seed(2)
    Bsz, L, H, P, N = 2, 16, 2, 4, 4
    x = torch.randn(Bsz, L, H, P, generator=g, requires_grad=True)
    dt = torch.rand(Bsz, L, H, generator=g).requires_grad_()
    A = -torch.rand(H, generator=g) - 0.5
    Bm, Cm = (torch.randn(Bsz, L, N, generator=g, requires_grad=True) for _ in range(2))
    return x, dt, A.requires_grad_(), Bm, Cm


def test_the_backward_is_one_scan_bwd_span():
    args = _intra_inputs()
    spans.enable()
    y, states, _ = _SSDIntraChunkFn.apply(*args, 8)
    (y.sum() + states.sum()).backward()
    spans.disable()
    names = _names(spans.take())
    assert names.count("ssm.scan.bwd") == 1
    grads_on = [t.grad.clone() for t in args]
    for t in args:
        t.grad = None
    y, states, _ = _SSDIntraChunkFn.apply(*args, 8)
    (y.sum() + states.sum()).backward()
    assert not spans.take().spans
    assert all(torch.equal(a, t.grad) for a, t in zip(grads_on, args))
