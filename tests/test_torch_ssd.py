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

The gradient: the intra-chunk part's backward (``_SSDIntraChunkFn``, its
plain version on the CPU) composed with ``inter_chunk``'s autograd is held
against ``jax.vjp`` of the reference's ``ssd_chunked`` (2e-5, scaled as
above, each gradient by its own largest element), and the plain backward
against autograd through ``ssd_intra_chunk_plain``.

JAX is imported inside the parity tests only: the card tests run on a
machine without it, with
``python -m pytest --noconftest -m gpu tests/test_torch_ssd.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (
    _SSDIntraChunkFn,
    inter_chunk,
    ssd_chunk_scan,
    ssd_chunk_scan_plain,
    ssd_intra_chunk,
    ssd_intra_chunk_bwd,
    ssd_intra_chunk_bwd_plain,
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


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device that is none of cuda, cpu and
    meta (``meta`` takes the plain version too: the dry-run's route)."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t):
    return torch.Tensor._make_subclass(_Elsewhere, t)


@pytest.mark.parametrize("bad", ["chunk", "dt", "device"])
def test_rejects_bad_input(bad):
    x, dt, A, Bm, Cm = _torch(_inputs(1, 32, 2, 8, 8, seed=6))
    chunk = 16
    if bad == "chunk":
        chunk = 24
    elif bad == "dt":
        dt = dt[:, :16]
    else:
        x, dt, A, Bm, Cm = (_elsewhere(t) for t in (x, dt, A, Bm, Cm))
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


# ---------------------------------------------------------------------------
# The gradient
# ---------------------------------------------------------------------------

GRAD_CASES = [
    (2, 64, 4, 8, 16, 16, False),
    (1, 96, 3, 8, 12, 32, True),     # an initial state, an odd H
    (2, 60, 2, 4, 8, 20, True),      # a chunk of 20 positions
    (1, 120, 4, 16, 32, 24, False),  # P and N wider, a chunk of 24
]


def _cotangents(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,L,H,P,N,chunk,init", GRAD_CASES)
def test_grad_matches_jax_vjp(B, L, H, P, N, chunk, init):
    """The intra-chunk backward (plain, on the CPU) composed with
    inter_chunk's autograd gives jax.vjp's dx, ddt, dA, dB and dC of the
    reference's ssd_chunked, for cotangents on y and the final state."""
    import jax
    import jax.numpy as jnp
    from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked

    arrs = _inputs(B, L, H, P, N, seed=L + H)
    gy, gh, h0 = _cotangents([(B, L, H, P), (B, H, P, N), (B, H, P, N)], seed=P)
    h0 = h0 if init else None
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = inter_chunk(*_SSDIntraChunkFn.apply(*ts, chunk), ts[4],
                       None if h0 is None else torch.from_numpy(h0), torch.float32)
    got = torch.autograd.grad((y, h), ts, (torch.from_numpy(gy), torch.from_numpy(gh)))

    def f(x, dt, A, Bm, Cm):
        return jax_ssd_chunked(x, dt, A, Bm, Cm, chunk, None if h0 is None else jnp.asarray(h0))

    (y_want, h_want), vjp = jax.vjp(f, *_jax(arrs))
    _close(y.detach(), y_want)
    _close(h.detach(), h_want)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                          vjp((jnp.asarray(gy), jnp.asarray(gh)))):
        assert g.shape == w.shape, name
        _close(g, w)


@pytest.mark.parametrize("B,L,H,P,N,chunk,init", GRAD_CASES)
def test_bwd_plain_matches_autograd(B, L, H, P, N, chunk, init):
    """The plain backward, written out in torch ops, equals autograd
    through ssd_intra_chunk_plain for cotangents on all three outputs."""
    del init
    ts = [torch.from_numpy(a).requires_grad_(True) for a in _inputs(B, L, H, P, N, seed=L)]
    outs = ssd_intra_chunk_plain(*ts, chunk)
    cots = [torch.from_numpy(c) for c in _cotangents([o.shape for o in outs], seed=H)]
    want = torch.autograd.grad(outs, ts, cots)
    got = ssd_intra_chunk_bwd(*(t.detach() for t in ts), outs[2].detach(), *cots)
    for g, w, t in zip(got, want, ts):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close_t(g, w)


def test_bwd_keeps_input_dtypes():
    """bf16 x, B and C get bf16 gradients; dt and A fp32 ones."""
    x, dt, A, Bm, Cm = _torch(_inputs(1, 32, 2, 8, 8, seed=7), dtype=torch.bfloat16)
    outs = ssd_intra_chunk_plain(x, dt, A, Bm, Cm, 16)
    got = ssd_intra_chunk_bwd(x, dt, A, Bm, Cm, outs[2], *(torch.ones_like(o) for o in outs))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]


def test_cpu_bwd_does_not_count_a_launch():
    args = _torch(_inputs(1, 32, 2, 8, 8, seed=8))
    outs = ssd_intra_chunk_plain(*args, 16)
    before = ssd_intra_chunk_bwd.launches
    ssd_intra_chunk_bwd(*args, outs[2], *(torch.ones_like(o) for o in outs))
    assert ssd_intra_chunk_bwd.launches == before


@pytest.mark.parametrize("bad", ["a_cs", "dy", "dstates", "da_cs"])
def test_bwd_rejects_mismatched_cotangents(bad):
    args = _torch(_inputs(1, 32, 2, 8, 8, seed=10))
    outs = list(ssd_intra_chunk_plain(*args, 16))
    saved = {"a_cs": outs[2], "dy": outs[0], "dstates": outs[1], "da_cs": outs[2]}
    saved[bad] = saved[bad][..., :-1]
    with pytest.raises(ValueError, match=bad):
        ssd_intra_chunk_bwd(*args, saved["a_cs"], saved["dy"], saved["dstates"], saved["da_cs"])


def test_function_gradient_of_one_output_matches_autograd():
    """A caller that uses y_diag alone gets the same gradient as autograd
    through the plain version (the unused outputs' cotangents arrive as
    zeros)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in _inputs(1, 64, 2, 8, 8, seed=13)]
    cot = torch.from_numpy(_cotangents([(1, 4, 2, 16, 8)], seed=1)[0])
    got = torch.autograd.grad(_SSDIntraChunkFn.apply(*ts, 16)[0], ts, cot)
    want = torch.autograd.grad(ssd_intra_chunk_plain(*ts, 16)[0], ts, cot)
    for g, w in zip(got, want):
        _close_t(g, w)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit masks: what ``cvt.rna.tf32.f32`` gives a finite value."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b, split_a=True, split_b=True):
    """The backward kernel's 3xTF32 product: each fp32 operand split into
    big = tf32(a) and small = tf32(a - big) (an operand that is exact in
    TF32, bf16-valued B or C, is not split); big . big in one accumulator,
    the small terms small(a) . big(b) and big(a) . small(b) in another,
    added to the first last."""
    ab, bb = (_tf32(a) if split_a else a), (_tf32(b) if split_b else b)
    small = torch.zeros(())
    if split_a:
        small = small + _tf32(a - ab) @ bb
    if split_b:
        small = small + ab @ _tf32(b - bb)
    return ab @ bb + small


def _mm_tf32(a, b, split_a=True, split_b=True):
    """One TF32 pass: both operands rounded to TF32."""
    return (_tf32(a) if split_a else a) @ (_tf32(b) if split_b else b)


def _mm_exact(a, b, split_a=True, split_b=True):
    del split_a, split_b
    return a @ b


def _bwd_products(x, dt, A, Bm, Cm, a_cs, dy, dst, da, mm, dtype):
    """The plain backward's formula (ssd_intra_chunk_bwd_plain) in `dtype`,
    with every product the kernel runs on the tensor cores taken by `mm`
    (a product with B or C, or with bf16-valued x, marks that operand
    exact), grouped as the kernel groups them: dt and the decay, which
    depend on s alone, applied after the products with x (dM = dt o (dy
    x^T), the states' term of dB summed over heads as (dt decay) o (x dst),
    u = dt o rowsum(x o decay o R)), dxdt = decay o R + M^T dy, G = C B^T
    exact (bf16-valued B and C: the kernel's bf16 products are exact)."""
    Bsz, L, H, P = x.shape
    N, Q = Bm.shape[-1], a_cs.shape[-1]
    n = L // Q
    x, dt, A, Bm, Cm, a, dy, dst, da = (t.to(dtype) for t in (x, dt, A, Bm, Cm, a_cs, dy, dst, da))
    xc = x.reshape(Bsz, n, Q, H, P).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(Bsz, n, Q, H).permute(0, 1, 3, 2)
    Bc, Cc = Bm.reshape(Bsz, n, Q, N), Cm.reshape(Bsz, n, Q, N)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    diff = (a[..., :, None] - a[..., None, :]).masked_fill(~tril, 0.0)
    Lm = torch.exp(diff).masked_fill(~tril, 0.0)
    M = Lm * (Cc @ Bc.transpose(-1, -2))[:, :, None]
    decay = torch.exp(a[..., -1:] - a)
    dM = (mm(dy, xc.transpose(-1, -2), split_b=False) * dtc[..., None, :]).masked_fill(~tril, 0.0)
    R = mm(Bc[:, :, None].expand(-1, -1, H, -1, -1), dst.transpose(-1, -2), split_a=False)
    dxdt = decay[..., None] * R + mm(M.transpose(-1, -2), dy)
    dG = (dM * Lm).sum(2)
    dC = mm(dG, Bc, split_b=False)
    dB = ((dtc * decay)[..., None] * mm(xc, dst, split_a=False)).sum(2) + mm(
        dG.transpose(-1, -2), Cc, split_b=False)
    dT = dM * M
    u = dtc * (xc * (decay[..., None] * R)).sum(-1)
    d_acs = da + dT.sum(-1) - dT.sum(-2) - u
    d_acs[..., -1] += u.sum(-1)
    dav = d_acs.flip(-1).cumsum(-1).flip(-1)
    ddt = dav * A[:, None] + (dxdt * xc).sum(-1)
    dA = (dav * dtc).sum((0, 1, 3))
    dx = dxdt * dtc[..., None]
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P),
            ddt.permute(0, 1, 3, 2).reshape(Bsz, L, H), dA, dB.reshape(Bsz, L, N),
            dC.reshape(Bsz, L, N))


def test_bwd_3xtf32_products_hold_the_tolerance():
    """The backward kernel runs every product on the tensor cores in
    3xTF32 (csrc/ssd_scan_bwd.cu).  Emulated here with TF32 rounding by bit
    masks, the same big/small split and grouping, at a chunk of 256 with
    bf16-valued x, B and C, dx, ddt, dA, dB and dC hold 2e-5 of max(1,
    max|ref|) against an fp64 evaluation of the same formula (the worst,
    dA, at 6.1e-6; fp32 products give 9.0e-6 there).  A single TF32 pass
    (both operands rounded once) errs by 1.2e-4 to 4.3e-4 of scale there,
    6 to 21 times the tolerance, which is why the kernel does not take it;
    bf16 operands would round the fp32 cotangents as well.  The formula
    itself is checked against ssd_intra_chunk_bwd_plain first."""
    B, L, H, P, N, Q = 1, 512, 4, 64, 128, 256
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(B, L, H, P, N, seed=31))
    x, Bm, Cm = (t.bfloat16().float() for t in (x, Bm, Cm))
    n = L // Q
    a_cs = torch.cumsum((dt.double() * A.double()).reshape(B, n, Q, H).permute(0, 1, 3, 2),
                        -1).float()
    dy, dst, da = (torch.from_numpy(c) for c in _cotangents(
        [(B, n, H, Q, P), (B, n, H, P, N), (B, n, H, Q)], seed=32))
    args = (x, dt, A, Bm, Cm, a_cs, dy, dst, da)
    plain = ssd_intra_chunk_bwd_plain(*args)
    for g, w in zip(_bwd_products(*args, _mm_exact, torch.float32), plain):
        _close_t(g, w)
    want = _bwd_products(*args, _mm_exact, torch.float64)
    one_pass = 0.0
    for name, g, o, w in zip(("dx", "ddt", "dA", "dB", "dC"),
                             _bwd_products(*args, _mm_3xtf32, torch.float32),
                             _bwd_products(*args, _mm_tf32, torch.float32), want):
        scale = max(1.0, w.abs().max().item())
        err = (g.double() - w).abs().max().item() / scale
        assert err <= 2e-5, (name, err)
        one_pass = max(one_pass, (o.double() - w).abs().max().item() / scale)
    assert one_pass > 2e-5, one_pass


def _bwd_case(B, L, H, P, N, chunk, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = _torch(_inputs(B, L, H, P, N, seed=seed), "cuda", dtype)
    a_cs = ssd_intra_chunk(*args, chunk)[2]
    n = L // chunk
    cots = [torch.randn(s, generator=gen, device="cuda")
            for s in ((B, n, H, chunk, P), (B, n, H, P, N), (B, n, H, chunk))]
    return args, a_cs, cots


BWD_CARD_CASES = [(2, 64, 4, 16, 32, 16), (2, 256, 8, 64, 128, 64), (1, 200, 4, 32, 16, 100),
                  (1, 192, 6, 64, 128, 96), (2, 300, 5, 16, 36, 150), (1, 512, 3, 64, 128, 256),
                  # mamba2-130m at full width: 24 heads; bf16 (3 heads a block): 8
                  # groups in 4 parts of a cluster of 2; fp32 (1 a block): 4 parts of 6
                  (4, 2048, 24, 64, 128, 256),
                  # 5 heads; bf16: one part, a cluster of 2 groups, the second short;
                  # fp32: 3 parts of 2, the last short; N off the mma's k16
                  (1, 512, 5, 64, 36, 256),
                  # 25 heads; bf16: 9 groups in 3 parts of a cluster of 3; fp32: 4
                  # parts of 7, the last short; the parts summed in the second kernel
                  (1, 256, 25, 32, 32, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk", BWD_CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain_on_card(B, L, H, P, N, chunk, dtype):
    """Card only: the backward kernel against its plain version computed in
    fp32 from the same inputs, one launch counted.  fp32: within 2e-5 of
    each gradient's scale; bf16 (dx, dB and dC come back in bf16):
    relative L2 <= 1e-2 per gradient."""
    _card()
    args, a_cs, cots = _bwd_case(B, L, H, P, N, chunk, dtype, seed=L + H)
    before = ssd_intra_chunk_bwd.launches
    got = ssd_intra_chunk_bwd(*args, a_cs, *cots)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_bwd.launches == before + 1
    want = ssd_intra_chunk_bwd_plain(*(t.float() for t in args), a_cs, *cots)
    for g, w, t in zip(got, want, args):
        assert g.dtype == t.dtype and g.shape == t.shape and bool(torch.isfinite(g).all())
        if dtype == torch.float32:
            _close_t(g, w)
        else:
            assert ((g.float() - w).norm() / w.norm()).item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk", [(2, 300, 5, 16, 36, 150), (4, 2048, 24, 64, 128, 256),
                                             (1, 512, 5, 64, 36, 256), (1, 256, 25, 32, 32, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_deterministic_on_card(B, L, H, P, N, chunk, dtype):
    """One writer per output and no atomics: a second launch is bit-equal."""
    _card()
    args, a_cs, cots = _bwd_case(B, L, H, P, N, chunk, dtype, seed=3)
    first = ssd_intra_chunk_bwd(*args, a_cs, *cots)
    second = ssd_intra_chunk_bwd(*args, a_cs, *cots)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("H", [13, 28])
def test_bwd_kernel_ragged_group_and_empty_cluster_blocks_on_card(H):
    """Card only: bf16 B and C, where the backward's blocks take 3 heads
    each and a cluster sums its blocks' partials.  13 heads make 5 groups in
    3 clusters of 2 and 28 make 10 in 4 clusters of 3: the last group holds
    one head, and the last cluster has a block with no head (as jamba's 256
    heads leave 2 of 88).  The gradients against the plain version (relative
    L2 <= 1e-2 each), and a second launch bit-equal."""
    _card()
    args, a_cs, cots = _bwd_case(1, 128, H, 32, 64, 64, torch.bfloat16, seed=H)
    first = ssd_intra_chunk_bwd(*args, a_cs, *cots)
    second = ssd_intra_chunk_bwd(*args, a_cs, *cots)
    want = ssd_intra_chunk_bwd_plain(*(t.float() for t in args), a_cs, *cots)
    for g, again, w, t in zip(first, second, want, args):
        assert g.dtype == t.dtype and g.shape == t.shape and torch.equal(g, again)
        assert ((g.float() - w).norm() / w.norm()).item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["P", "N", "dtype", "mixed"])
def test_bwd_kernel_refuses_before_any_launch_on_card(bad):
    _card()
    shape = {"P": (1, 64, 2, 68, 16), "N": (1, 64, 2, 16, 132)}.get(bad, (1, 64, 2, 16, 16))
    args = list(_torch(_inputs(*shape, seed=4), "cuda"))
    if bad == "dtype":
        args = [t.half() if i in (0, 3, 4) else t for i, t in enumerate(args)]
    elif bad == "mixed":
        args[3] = args[3].bfloat16()
    n = 64 // 16
    B, L, H, P = args[0].shape
    N = args[3].shape[-1]
    z = torch.zeros
    before = (ssd_intra_chunk_bwd.launches, ssd_chunk_scan.launches)
    with pytest.raises((TypeError, ValueError)):
        ssd_intra_chunk_bwd(*args, z((B, n, H, 16), device="cuda"), z((B, n, H, 16, P), device="cuda"),
                            z((B, n, H, P, N), device="cuda"), z((B, n, H, 16), device="cuda"))
    assert (ssd_intra_chunk_bwd.launches, ssd_chunk_scan.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("init", [False, True])
def test_scan_gradient_on_card_matches_cpu(init):
    """Card only: ssd_chunk_scan on CUDA inputs that need a gradient goes
    through the forward and backward kernels (one launch each) and gives the
    CPU's autograd gradient of ssd_chunked within 2e-5 of each scale."""
    _card()
    arrs = _inputs(2, 300, 5, 16, 36, seed=21)
    gy, gh, h0 = _cotangents([(2, 300, 5, 16), (2, 5, 16, 36), (2, 5, 16, 36)], seed=22)
    grads = {}
    for device in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(device).requires_grad_(True) for a in arrs]
        before = (ssd_chunk_scan.launches, ssd_intra_chunk_bwd.launches)
        y, h = ssd_chunk_scan(*ts, chunk=150,
                              initial_state=torch.from_numpy(h0).to(device) if init else None)
        g = torch.autograd.grad((y, h), ts, (torch.from_numpy(gy).to(device),
                                             torch.from_numpy(gh).to(device)))
        after = (ssd_chunk_scan.launches, ssd_intra_chunk_bwd.launches)
        assert after == ((before[0] + 1, before[1] + 1) if device == "cuda" else before)
        grads[device] = [t.cpu() for t in g]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        _close_t(g, w)


def test_inter_chunk_backward_stacks_chunk_gradients_once():
    """inter_chunk walks the chunks by unbind: no node of its backward
    takes a slice of the whole states tensor (an index's backward would
    fill a states-sized zero tensor a chunk and add them all), and its
    gradient equals the indexing loop's."""
    x, dt, A, Bm, Cm = _torch(_inputs(1, 128, 2, 8, 8, seed=14))
    y_diag, states, a_cs = (t.requires_grad_(True) for t in ssd_intra_chunk_plain(
        x, dt, A, Bm, Cm, 16))
    y, h = inter_chunk(y_diag, states, a_cs, Cm, None, torch.float32)
    seen, todo, sizes = set(), [y.grad_fn, h.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "SelectBackward0":
            sizes.append(tuple(node._saved_self_sym_sizes))
        todo += [f for f, _ in node.next_functions]
    assert tuple(states.shape) not in sizes
    cots = [torch.ones_like(y), torch.ones_like(h)]
    got = torch.autograd.grad((y, h), (states, a_cs), cots)

    def indexing_loop(states, a_cs):
        h = torch.zeros_like(states[:, 0])
        h_prevs = []
        for c in range(states.shape[1]):
            h_prevs.append(h)
            h = h * torch.exp(a_cs[:, c, :, -1])[:, :, None, None] + states[:, c]
        y_off = torch.einsum("bcln,bchpn,bchl->bchlp", Cm.reshape(1, 8, 16, 8),
                             torch.stack(h_prevs, dim=1), torch.exp(a_cs))
        return (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(1, 128, 2, 8), h

    want = torch.autograd.grad(indexing_loop(states, a_cs), (states, a_cs), cots)
    for g, w in zip(got, want):
        _close_t(g, w)
