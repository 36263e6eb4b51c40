"""The port's SSD chunked scan (``ssd_chunk_scan``) against the reference's
Pallas kernel, its oracles and the plain version.

On the CPU the port's wrapper runs its plain version (the port's
``ssd_chunked``); the reference's kernel runs in Pallas interpret mode, as
tests/test_kernels.py runs it.  Both get the same numpy inputs:
x, B, C ~ N(0, 1), dt = softplus(N(0, 1)), A = -exp(N(0, 1)), the
reference's own distribution.  Tolerances are the reference's: 2e-5
against the chunked kernel, 1e-3 against the O(L) sequential recurrence
(whose products are summed in another order over a whole sequence).  The
absolute part is taken relative to the output's scale (``tol *
max(1, max|want|)``): y sums chunk-long runs of products as large as
max|y| (about 25 here), so summing them in another order than XLA does
leaves absolute errors in proportion to the largest terms, and an
element that cancels to near 0 keeps that absolute error.

JAX is imported inside the parity tests only: the card tests run on a
machine without it, with
``python -m pytest --noconftest -m gpu tests/test_torch_ssd.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (
    inter_chunk,
    ssd_chunk_scan,
    ssd_chunk_scan_plain,
    ssd_intra_chunk,
    ssd_intra_chunk_plain,
)
from repro_torch.models.mamba2 import ssd_chunked, ssd_reference


def _inputs(B, L, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(arrs, device="cpu", dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(device) for a in arrs)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _close(got, want, tol=2e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _close_t(got, want, tol=2e-5):
    """torch.testing.assert_close with the same scaled absolute part."""
    scale = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol)


def _jax(arrs):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("L,H,P,N,chunk", [
    (64, 4, 16, 32, 16),
    (128, 8, 32, 64, 32),
])
def test_plain_matches_pallas(L, H, P, N, chunk):
    from repro.kernels import ops as jax_ops

    arrs = _inputs(2, L, H, P, N, seed=L + H)
    y_want, h_want = jax_ops.ssd_scan(*_jax(arrs), chunk=chunk, block_h=4, interpret=True)
    y_got, h_got = ops.ssd_scan(*_torch(arrs), chunk=chunk)
    assert y_got.shape == (2, L, H, P) and h_got.shape == (2, H, P, N)
    _close(y_got, y_want)
    _close(h_got, h_want)


def test_plain_scan_does_not_depend_on_fp32_exp_accuracy(monkeypatch):
    """Pins the cause of ``test_plain_matches_pallas[64-4-16-32-16]``'s
    flakiness: on a first call in a process after other tests, torch's
    fp32 ``exp`` returned one worker thread's share of the 8192 decay
    weights exp(segsum) with up to 1.5e-4 relative error (segsum itself
    bit-equal), moving y by up to 5e-3 against a tolerance of 1.3e-3.
    The plain scan now evaluates its decays in fp64, so an fp32 ``exp``
    that errs by that much leaves its output bit for bit unchanged."""
    arrs = _inputs(2, 64, 4, 16, 32, seed=68)
    y_want, h_want = ops.ssd_scan(*_torch(arrs), chunk=16)
    real_exp = torch.exp

    def lossy_fp32_exp(x, *args, **kwargs):
        out = real_exp(x, *args, **kwargs)
        return out * (1 + 1.5e-4) if x.dtype == torch.float32 else out

    monkeypatch.setattr(torch, "exp", lossy_fp32_exp)
    y_got, h_got = ops.ssd_scan(*_torch(arrs), chunk=16)
    assert torch.equal(y_got, y_want) and torch.equal(h_got, h_want)


def test_plain_matches_sequential_semantics():
    """Chunked == exact O(L) recurrence, in both packages' oracles."""
    from repro.kernels import ref as jax_ref

    arrs = _inputs(1, 96, 4, 8, 16, seed=3)
    y_got, h_got = ops.ssd_scan(*_torch(arrs), chunk=32)
    y_seq, h_seq = ref.ssd_scan_sequential_ref(*_torch(arrs))
    _close(y_got, y_seq, 1e-3)
    _close(h_got, h_seq, 1e-3)
    y_jseq, h_jseq = jax_ref.ssd_scan_sequential_ref(*_jax(arrs))
    _close(y_seq, y_jseq)
    _close(h_seq, h_jseq)


def test_initial_state_continuation():
    """Splitting a sequence in two with state carry == one long scan, and
    the continuation equals the reference's."""
    from repro.kernels import ops as jax_ops

    arrs = _inputs(1, 128, 4, 8, 16, seed=11)
    x, dt, A, Bm, Cm = _torch(arrs)
    y_full, h_full = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    half = 64
    _, h1 = ops.ssd_scan(x[:, :half], dt[:, :half], A, Bm[:, :half], Cm[:, :half], chunk=32)
    y2, h2 = ops.ssd_scan(x[:, half:], dt[:, half:], A, Bm[:, half:], Cm[:, half:], chunk=32,
                          initial_state=h1)
    _close(y_full[:, half:], y2, 1e-3)
    _close(h_full, h2, 1e-3)
    jx, jdt, jA, jB, jC = _jax(arrs)
    _, jh1 = jax_ops.ssd_scan(jx[:, :half], jdt[:, :half], jA, jB[:, :half], jC[:, :half],
                              chunk=32, block_h=4, interpret=True)
    jy2, jh2 = jax_ops.ssd_scan(jx[:, half:], jdt[:, half:], jA, jB[:, half:], jC[:, half:],
                                chunk=32, block_h=4, interpret=True, initial_state=jh1)
    _close(y2, jy2)
    _close(h2, jh2)


def test_ref_is_the_plain_version():
    args = _torch(_inputs(1, 32, 2, 8, 8, seed=2))
    assert ref.ssd_scan_ref is ssd_chunk_scan_plain
    for a, b in zip(ssd_chunk_scan(*args, chunk=16), ssd_chunked(*args, 16)):
        assert torch.equal(a, b)


def test_cpu_call_does_not_count_a_launch():
    before = ssd_chunk_scan.launches
    ssd_chunk_scan(*_torch(_inputs(1, 32, 2, 8, 8, seed=4)), chunk=16)
    assert ssd_chunk_scan.launches == before


@pytest.mark.parametrize("bad", ["chunk", "dt", "device"])
def test_rejects_bad_input(bad):
    x, dt, A, Bm, Cm = _torch(_inputs(1, 32, 2, 8, 8, seed=6))
    chunk = 16
    if bad == "chunk":
        chunk = 24
    elif bad == "dt":
        dt = dt[:, :16]
    else:
        x, dt, A, Bm, Cm = (t.to("meta") for t in (x, dt, A, Bm, Cm))
    with pytest.raises((TypeError, ValueError)):
        ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)


@pytest.mark.parametrize("view,ok", [
    ("contiguous", True),
    ("xbc_split", True),        # B and C as column slices of one (B, L, 2N + 4) projection
    ("offset_two", False),      # the base 2 elements past a multiple of 4
    ("row_pad_2", False),       # rows 2 elements past a multiple of 4
    ("every_other", False),     # the last axis not contiguous
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_vectorized_is_what_the_kernel_reads(view, ok, dtype):
    """The kernel reads x, B and C 4 elements at a time: the wrapper hands
    it a tensor whose base and strides allow that as it is and copies any
    other (also a contiguous one whose base is off); its launcher refuses
    the rest."""
    from repro_torch.kernels.ssd_scan import _as_vectorized, _rows_vectorized

    B, L, N = 2, 8, 16
    buf = torch.arange(B * L * (2 * N + 4) + 8, dtype=torch.float32).to(dtype)
    views = {
        "contiguous": lambda: buf[:B * L * N].view(B, L, N),
        "xbc_split": lambda: buf[:B * L * (2 * N + 4)].view(B, L, 2 * N + 4)[..., N + 4:],
        "offset_two": lambda: buf[2:2 + B * L * N].view(B, L, N),
        "row_pad_2": lambda: buf[:B * L * (N + 2)].view(B, L, N + 2)[..., :N],
        "every_other": lambda: buf[:B * L * 2 * N].view(B, L, 2 * N)[..., ::2],
    }
    t = views[view]()
    assert _rows_vectorized(t) is ok
    fixed = _as_vectorized(t)
    assert _rows_vectorized(fixed) and torch.equal(fixed, t)
    assert (fixed.data_ptr() == t.data_ptr()) is ok


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (2, 64, 4, 16, 32, 16),
    (2, 128, 8, 32, 64, 32),
    (2, 256, 8, 64, 128, 64),
    (1, 512, 4, 64, 128, 256),    # mamba2-130m's chunk, P and N
    (1, 96, 4, 8, 16, 32),
    (2, 200, 4, 32, 16, 100),     # a chunk that is not a multiple of 64
    (1, 192, 6, 64, 128, 96),     # H not a multiple of the kernel's head group (4)
    (2, 300, 5, 16, 36, 150),     # an odd H and pair of heads, N not a multiple of 16
    (1, 320, 7, 32, 64, 160),
])
def test_kernel_matches_plain_on_card(B, L, H, P, N, chunk):
    """Card only: the kernel (with the torch-side inter-chunk part) against
    the plain version on the same fp32 inputs, one launch each."""
    _card()
    args = _torch(_inputs(B, L, H, P, N, seed=L + N), "cuda")
    before = ssd_chunk_scan.launches
    y, h = ssd_chunk_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + 1
    y_want, h_want = ssd_chunk_scan_plain(*args, chunk)
    _close_t(y, y_want)
    _close_t(h, h_want)
    y_seq, h_seq = ssd_reference(*args)
    _close_t(y, y_seq, 1e-3)
    _close_t(h, h_seq, 1e-3)


@pytest.mark.gpu
def test_kernel_continuation_on_card():
    _card()
    x, dt, A, Bm, Cm = _torch(_inputs(1, 128, 4, 8, 16, seed=11), "cuda")
    y_full, h_full = ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=32)
    _, h1 = ssd_chunk_scan(x[:, :64], dt[:, :64], A, Bm[:, :64], Cm[:, :64], chunk=32)
    y2, h2 = ssd_chunk_scan(x[:, 64:], dt[:, 64:], A, Bm[:, 64:], Cm[:, 64:], chunk=32,
                            initial_state=h1)
    _close_t(y_full[:, 64:], y2, 1e-3)
    _close_t(h_full, h2, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk", [(2, 256, 8, 64, 128, 64), (1, 192, 6, 64, 128, 96),
                                             (2, 300, 5, 16, 36, 150)])
def test_kernel_bf16_on_card(B, L, H, P, N, chunk):
    """bf16 x, B, C (the model's activation dtype): the kernel and the
    plain version read the same bf16 values and work in fp32 (the kernel
    forms the scores on the tensor cores, exact products summed in fp32);
    y comes back in bf16, so 2e-2."""
    _card()
    args = _torch(_inputs(B, L, H, P, N, seed=1), "cuda", torch.bfloat16)
    y, h = ssd_chunk_scan(*args, chunk=chunk)
    y_want, h_want = ssd_chunk_scan_plain(*args, chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close_t(y.float(), y_want.float(), 2e-2)
    _close_t(h, h_want)


@pytest.mark.gpu
def test_kernel_refuses_grad_on_card():
    _card()
    x, dt, A, Bm, Cm = _torch(_inputs(1, 32, 2, 8, 8, seed=9), "cuda")
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=16)


def test_intra_plain_and_inter_chunk_compose_to_the_scan():
    """The kernel's plain version (the Pallas kernel's three outputs) and
    the torch-side inter-chunk part together give ssd_chunked, with and
    without an initial state; the intra part matches the Pallas kernel's
    outputs in interpret mode."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from repro.kernels.ssd_scan import _ssd_kernel
    import jax

    arrs = _inputs(2, 64, 4, 8, 16, seed=12)
    x, dt, A, Bm, Cm = _torch(arrs)
    h0 = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 8, 16)).astype(np.float32))
    for init in (None, h0):
        y, h = inter_chunk(*ssd_intra_chunk_plain(x, dt, A, Bm, Cm, 16), Cm, init, x.dtype)
        y_want, h_want = ssd_chunked(x, dt, A, Bm, Cm, 16, init)
        _close(y, y_want)
        _close(h, h_want)
    # The Pallas kernel itself, one block per (b, chunk, all 4 heads).
    jx, jdt, jA, jB, jC = _jax(arrs)
    Bsz, L, H, P, N, Q = 2, 64, 4, 8, 16, 16
    C = L // Q
    outs = pl.pallas_call(
        _ssd_kernel,
        out_shape=(jax.ShapeDtypeStruct((Bsz, C, H, Q, P), jnp.float32),
                   jax.ShapeDtypeStruct((Bsz, C, H, P, N), jnp.float32),
                   jax.ShapeDtypeStruct((Bsz, C, H, Q), jnp.float32)),
        grid=(Bsz, C, 1),
        in_specs=[pl.BlockSpec((1, 1, H, Q, P), lambda b, c, h: (b, c, 0, 0, 0)),
                  pl.BlockSpec((1, 1, H, Q), lambda b, c, h: (b, c, 0, 0)),
                  pl.BlockSpec((H, 1), lambda b, c, h: (0, 0)),
                  pl.BlockSpec((1, 1, Q, N), lambda b, c, h: (b, c, 0, 0)),
                  pl.BlockSpec((1, 1, Q, N), lambda b, c, h: (b, c, 0, 0))],
        out_specs=(pl.BlockSpec((1, 1, H, Q, P), lambda b, c, h: (b, c, 0, 0, 0)),
                   pl.BlockSpec((1, 1, H, P, N), lambda b, c, h: (b, c, 0, 0, 0)),
                   pl.BlockSpec((1, 1, H, Q), lambda b, c, h: (b, c, 0, 0))),
        interpret=True,
    )(jx.reshape(Bsz, C, Q, H, P).transpose(0, 1, 3, 2, 4),
      jdt.reshape(Bsz, C, Q, H).transpose(0, 1, 3, 2), jA.reshape(H, 1),
      jB.reshape(Bsz, C, Q, N), jC.reshape(Bsz, C, Q, N))
    for got, want in zip(ssd_intra_chunk_plain(x, dt, A, Bm, Cm, Q), outs):
        _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk", [(2, 256, 8, 64, 128, 64), (1, 200, 4, 32, 16, 100),
                                             (1, 192, 6, 64, 128, 96), (2, 300, 5, 16, 36, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_alone_matches_its_plain_version_on_card(B, L, H, P, N, chunk, dtype):
    """Card only: the kernel's three outputs against ssd_intra_chunk_plain,
    both reading the same fp32 or bf16 inputs."""
    _card()
    args = _torch(_inputs(B, L, H, P, N, seed=L), "cuda", dtype)
    got = ssd_intra_chunk(*args, chunk)
    want = ssd_intra_chunk_plain(*args, chunk)
    for g, w in zip(got, want):
        _close_t(g, w)
