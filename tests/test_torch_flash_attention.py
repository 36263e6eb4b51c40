"""The port's flash_attention against the reference's Pallas kernel and
its plain version.

On the CPU the port's wrapper runs its plain version (the port's
``causal_attention`` / ``full_attention``); the reference's kernel runs in
Pallas interpret mode, as tests/test_kernels.py runs it.  Both get the
same numpy inputs.  Tolerances are the reference's kernel tolerances
(tests/test_kernels.py): 2e-5 for fp32, 2e-2 for bf16.  In bf16 the two
differ by more than summation order: the plain version rounds the softmax
weights to bf16 before the product with V, the Pallas kernel (and the
port's CUDA kernel) keep them in fp32.

JAX is imported inside the parity tests only: the card tests run on a
machine without it, with
``python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (
    attention_lse_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _qkv(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=_DTYPES[dtype]) for a in arrs]


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


def _pallas(q, k, v, dtype, **kw):
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops

    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    return np.asarray(jax_ops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                              interpret=True, **kw), np.float32)


@pytest.mark.parametrize("seq,heads,kv,dim", [
    (128, 4, 4, 64),    # MHA
    (128, 8, 2, 64),    # GQA 4:1
    (128, 4, 1, 128),   # MQA, olmo-1b's head width
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_causal(seq, heads, kv, dim, dtype):
    q, k, v = _qkv(1, seq, heads, kv, dim, seed=seq + heads + kv)
    want = _pallas(q, k, v, dtype)
    got = ops.flash_attention(*_torch((q, k, v), dtype))
    assert got.dtype == _DTYPES[dtype] and got.shape == (1, seq, heads, dim)
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_plain_matches_pallas_sliding_window(window):
    q, k, v = _qkv(1, 128, 4, 2, 64, seed=window)
    _close(ops.flash_attention(*_torch((q, k, v), "float32"), window=window),
           _pallas(q, k, v, "float32", window=window), "float32")


def test_plain_matches_pallas_noncausal():
    q, k, v = _qkv(2, 64, 4, 4, 64, seed=0)
    _close(ops.flash_attention(*_torch((q, k, v), "float32"), causal=False),
           _pallas(q, k, v, "float32", causal=False), "float32")


@pytest.mark.parametrize("seq", [100, 37])
def test_ragged_seq_matches_reference_oracle(seq):
    """The reference's kernel asserts S % block == 0; the port takes any S.
    Its oracle (causal_attention) takes any S: hold the port to it."""
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref

    q, k, v = _qkv(2, seq, 4, 2, 64, seed=seq)
    for window in (None, 16):
        want = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           window=window)
        _close(ops.flash_attention(*_torch((q, k, v), "float32"), window=window),
               want, "float32")


def test_ref_is_the_plain_version():
    q, k, v = _torch(_qkv(1, 32, 2, 1, 64, seed=3), "float32")
    assert ref.flash_attention_ref is flash_attention_plain
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))


def test_cpu_call_does_not_count_a_launch():
    before = flash_attention.launches
    flash_attention(*_torch(_qkv(1, 16, 2, 2, 64, seed=4), "float32"))
    assert flash_attention.launches == before


@pytest.mark.parametrize("bad", ["dtype", "heads", "window", "device", "shape"])
def test_rejects_bad_input(bad):
    """Nothing but a CPU tensor reaches the plain version: another device
    raises instead of falling back."""
    q, k, v = _torch(_qkv(1, 16, 4, 2, 64, seed=5), "float32")
    kw = {}
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "heads":
        k, v = torch.zeros(1, 16, 3, 64), torch.zeros(1, 16, 3, 64)
    elif bad == "window":
        kw = {"causal": False, "window": 8}
    elif bad == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    else:
        k = k[:, :8]
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("view,aligned", [
    ("contiguous", True),
    ("fused_qkv", True),         # heads strided inside a (B, S, 3, H, D) projection
    ("offset_one", False),       # the base 2 bytes past 16
    ("row_pad_4", False),        # rows 8 bytes past a multiple of 16
    ("expanded", False),         # a stride of 0
    ("every_other", False),      # D not contiguous
])
def test_rows_aligned_is_what_tma_addresses(view, aligned):
    """The bf16 kernel reads q, k and v with TMA: a base on 16 bytes and
    positive strides that are multiples of 16 bytes.  The wrapper hands the
    kernel such a tensor as it is and copies any other; its launcher
    refuses the rest."""
    from repro_torch.kernels.flash_attention import _as_aligned, _rows_aligned

    B, S, H, D = 2, 8, 4, 64
    buf = torch.zeros(B * S * 3 * H * D + 8, dtype=torch.bfloat16)
    base = buf[:B * S * H * D].view(B, S, H, D)
    views = {
        "contiguous": lambda: base,
        "fused_qkv": lambda: buf[:B * S * 3 * H * D].view(B, S, 3, H, D)[:, :, 1],
        "offset_one": lambda: buf[1:1 + B * S * H * D].view(B, S, H, D),
        "row_pad_4": lambda: buf[:B * S * H * (D + 4)].view(B, S, H, D + 4)[..., :D],
        "expanded": lambda: base[:, :1].expand(B, S, H, D),
        "every_other": lambda: buf[:B * S * H * 2 * D].view(B, S, H, 2 * D)[..., ::2],
    }
    t = views[view]()
    assert buf.data_ptr() % 16 == 0
    assert _rows_aligned(t) is aligned
    fixed = _as_aligned(t)
    assert _rows_aligned(fixed) and torch.equal(fixed, t)
    assert (fixed.data_ptr() == t.data_ptr()) is aligned


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, S, H, KV, D, causal, window)
    (2, 256, 4, 4, 64, True, None),      # MHA
    (2, 256, 8, 2, 64, True, None),      # GQA 4:1
    (1, 256, 4, 1, 128, True, None),     # MQA
    (1, 256, 4, 2, 64, True, 16),
    (1, 256, 4, 2, 64, True, 64),
    (1, 256, 4, 2, 128, True, 100),
    (2, 128, 4, 4, 64, False, None),     # full attention
    (2, 100, 4, 2, 64, True, None),      # ragged S
    (1, 300, 4, 4, 128, True, None),
    (1, 300, 4, 4, 128, False, None),
    (1, 300, 4, 2, 64, True, 100),
    # The bf16 kernel's tile edges (128 query rows, 128-key tiles).
    (1, 130, 4, 2, 128, True, None),     # S just past a tile
    (1, 1000, 4, 1, 64, True, None),     # S past a multiple of 64, MQA
    (2, 40, 4, 4, 64, True, None),       # S below 64
    (1, 130, 4, 4, 128, False, None),
    (1, 1000, 8, 2, 128, True, 200),     # a window across tiles
    (1, 256, 8, 2, 128, True, None),     # GQA 4:1 at D 128
    (1, 256, 4, 1, 64, True, None),      # MQA at D 64
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(case, dtype):
    """Card only: the CUDA kernel against its plain version on the same
    inputs, one launch each."""
    _card()
    B, S, H, KV, D, causal, window = case
    q, k, v = _torch(_qkv(B, S, H, KV, D, seed=S + H + D), dtype, "cuda")
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.gpu
def test_kernel_strided_inputs_on_card():
    """q, k, v as views of one fused projection (strided heads), the layout
    a fused QKV matmul would hand over: no copy, same result."""
    _card()
    B, S, H, D = 2, 192, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device="cuda")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_kernel_misaligned_base_on_card():
    """bf16 q, k, v that are contiguous but start 2 bytes past 16 (TMA
    cannot read them): the wrapper copies them, and the result is the
    aligned inputs' result."""
    _card()
    B, S, H, D = 1, 200, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    bufs = [torch.randn(B * S * H * D + 1, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]
    q, k, v = (b[1:].view(B, S, H, D) for b in bufs)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    got = flash_attention(q, k, v)
    want = flash_attention(q.clone(), k.clone(), v.clone())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_kernel_refuses_grad_on_card():
    """A CUDA input that needs a gradient gets the hand-written backward
    (one forward and one backward launch) or an error, never autograd
    through the plain version: a head width the kernels are not built for
    is refused before anything runs."""
    _card()
    q, k, v = _torch(_qkv(1, 64, 2, 2, 64, seed=9), "float32", "cuda")
    q.requires_grad_(True)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    flash_attention(q, k, v).sum().backward()
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    q96, k96, v96 = _torch(_qkv(1, 64, 2, 2, 96, seed=9), "float32", "cuda")
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(q96.requires_grad_(True), k96, v96)
    with torch.no_grad():
        flash_attention(q, k, v)



# ---------------------------------------------------------------------------
# The gradient: autograd through the plain version against jax.grad of the
# reference's attention, and the closed form against autograd
# ---------------------------------------------------------------------------

_BWD_CASES = [
    # (B, S, H, KV, D, causal, window)
    (1, 64, 4, 4, 16, True, None),     # MHA
    (2, 48, 8, 2, 16, True, None),     # GQA 4:1
    (1, 40, 4, 1, 32, True, None),     # MQA
    (1, 64, 4, 2, 16, True, 9),        # sliding window
    (2, 37, 4, 2, 16, True, None),     # ragged S
    (1, 1, 2, 2, 16, True, None),      # one position
    (2, 33, 4, 2, 16, False, None),    # full attention, ragged S
]


def _jax_attention(causal, window):
    from repro.models.layers import causal_attention, full_attention

    if causal:
        return lambda q, k, v: causal_attention(q, k, v, sliding_window=window)
    return full_attention


@pytest.mark.parametrize("case", _BWD_CASES)
def test_autograd_of_plain_matches_jax_grad(case):
    """fp32: the port's CPU gradient (autograd through
    ``flash_attention_plain``) against ``jax.grad`` of the reference's
    ``causal_attention`` / ``full_attention``, within 2e-5."""
    import jax
    import jax.numpy as jnp

    B, S, H, KV, D, causal, window = case
    q, k, v = _qkv(B, S, H, KV, D, seed=S + H + D)
    dout = np.random.default_rng(1).standard_normal((B, S, H, D)).astype(np.float32)
    fn = _jax_attention(causal, window)
    jg = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * dout), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _torch((q, k, v), "float32"))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(dout))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, np.asarray(want), "float32")


@pytest.mark.parametrize("case", _BWD_CASES)
def test_bwd_plain_matches_autograd(case):
    """The backward kernel's plain version (P from the log-sum-exp, dS = P
    (dP - Delta)) against autograd of the forward, fp32 within 2e-5; the
    log-sum-exp against torch.logsumexp of the masked scores."""
    B, S, H, KV, D, causal, window = case
    q, k, v = _torch(_qkv(B, S, H, KV, D, seed=S + H + D + 1), "float32")
    dout = torch.from_numpy(np.random.default_rng(2).standard_normal((B, S, H, D))
                            .astype(np.float32))
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    out.backward(dout)
    lse = attention_lse_plain(q, k, causal=causal, window=window)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    got = flash_attention_bwd(q, k, v, out.detach(), lse, dout, causal=causal, window=window)
    for g, want in zip(got, (tq.grad, tk.grad, tv.grad)):
        assert g.dtype == torch.float32 and g.shape == want.shape
        _close(g, want.numpy(), "float32")
    assert flash_attention_bwd_plain(q, k, v, out.detach(), lse, dout, causal, window)[0] \
        .shape == q.shape


def test_bwd_rejects_mismatched_saved_tensors():
    q, k, v = _torch(_qkv(1, 16, 2, 2, 16, seed=0), "float32")
    lse = attention_lse_plain(q, k)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bwd(q, k, v, q, lse[:, :, :8], q)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bwd(q, k, v, q[:, :8], lse, q)


def test_cpu_backward_launches_no_kernel():
    q, k, v = (t.requires_grad_(True) for t in _torch(_qkv(1, 32, 2, 2, 16, seed=3), "float32"))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    flash_attention(q, k, v).sum().backward()
    flash_attention_bwd(q.detach(), k.detach(), v.detach(), q.detach(),
                        attention_lse_plain(q.detach(), k.detach()), q.detach())
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, S, H, KV, D, causal, window)
    (2, 256, 4, 4, 64, True, None),
    (1, 512, 32, 8, 128, True, None),     # GQA 4:1
    (1, 1000, 8, 2, 128, True, 200),      # a window across tiles
    (2, 300, 4, 4, 128, False, None),     # full attention, ragged S
    (1, 1000, 4, 1, 64, True, None),      # ragged S, MQA
    (2, 130, 4, 2, 128, True, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_matches_plain_on_card(case, dtype):
    """Card only: the backward kernel against its plain version computed in
    fp32 from the same inputs (one launch).  bf16: relative L2 <= 1e-2 per
    gradient; fp32: within 2e-5 of each gradient's max |.|; the forward's
    log-sum-exp within 2e-5 of the plain one's scale."""
    _card()
    B, S, H, KV, D, causal, window = case
    q, k, v = _torch(_qkv(B, S, H, KV, D, seed=S + H + D), dtype, "cuda")
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                       device="cuda").to(q.dtype)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    before = flash_attention_bwd.launches
    out.backward(dout)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    lse = attention_lse_plain(q.float(), k.float(), causal, window)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.detach().float(), lse,
                                     dout.float(), causal, window)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == q.dtype and got.shape == w.shape
        if dtype == "bfloat16":
            assert _rel_l2(got, w) <= 1e-2
        else:
            assert (got - w).abs().max().item() <= 2e-5 * max(1.0, w.abs().max().item())


@pytest.mark.gpu
def test_bwd_kernel_one_position_and_misaligned_on_card():
    """S = 1 (dq and dk are 0 in exact arithmetic: one key, P = 1) and a
    bf16 q whose base is 2 bytes past 16 (the wrapper copies it)."""
    _card()
    q, k, v = _torch(_qkv(1, 1, 4, 2, 128, seed=1), "bfloat16", "cuda")
    lse = attention_lse_plain(q, k)
    o = flash_attention(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q))
    scale = dv.float().abs().max().item()
    assert dq.float().abs().max().item() <= 1e-2 * scale
    assert dk.float().abs().max().item() <= 1e-2 * scale
    B, S, H, D = 1, 200, 4, 128
    buf = torch.randn(B * S * H * D + 1, device="cuda").bfloat16()
    qm = buf[1:].view(B, S, H, D)
    assert qm.data_ptr() % 16 != 0
    k2, v2 = (torch.randn(B, S, H, D, device="cuda").bfloat16() for _ in range(2))
    lse2 = attention_lse_plain(qm, k2)
    o2 = flash_attention(qm, k2, v2)
    got = flash_attention_bwd(qm, k2, v2, o2, lse2, o2)
    want = flash_attention_bwd(qm.clone(), k2, v2, o2, lse2, o2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
