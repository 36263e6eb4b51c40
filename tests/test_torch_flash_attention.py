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
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

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
def test_kernel_refuses_grad_on_card():
    """No backward exists: a CUDA input that needs a gradient raises rather
    than returning an output with wrong gradients."""
    _card()
    q, k, v = _torch(_qkv(1, 64, 2, 2, 64, seed=9), "float32", "cuda")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        flash_attention(q, k, v)
