"""The port's fedavg_reduce (and, on the card, dequant_fold) against the
reference's Pallas kernel and the plain versions.

On the CPU the port's wrapper runs its plain version; the reference's
kernel runs in Pallas interpret mode, as tests/test_kernels.py runs it.
Both get the same numpy inputs.  Tolerances are the reference's kernel
tolerances (tests/test_kernels.py): 2e-5 for fp32, 2e-2 for bf16 (bf16
keeps 8 bits of mantissa, and the two frameworks round the bf16 inputs
the same way but may sum in another order).

JAX is imported inside the parity tests only: the machine with the card
has no JAX, and runs this file's card tests there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.fedavg_reduce import BLOCK, fedavg_reduce, fedavg_reduce_plain

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _inputs(n_clients, length, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_clients, length)).astype(np.float32)
    w = rng.uniform(0.5, 5.0, n_clients).astype(np.float32)
    return x, w


def _torch_buffer(x, tdt):
    return torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("n_clients", [2, 5, 16])
@pytest.mark.parametrize("length", [100, 8192, 20000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_matches_pallas(n_clients, length, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops

    tdt = _DTYPES[dtype]
    x, w = _inputs(n_clients, length, seed=1000 * n_clients + length)
    want = jax_ops.fedavg_reduce(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
                                 use_pallas=True, interpret=True)
    got = ops.fedavg_reduce(_torch_buffer(x, tdt), torch.from_numpy(w))
    assert got.shape == (length,) and got.dtype == tdt
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=_tol(dtype), rtol=_tol(dtype)
    )


def test_fedavg_reduce_weights_normalized():
    x = torch.stack([torch.ones(100), 3 * torch.ones(100)])
    got = ops.fedavg_reduce(x, torch.tensor([1.0, 1.0]))
    np.testing.assert_allclose(got.numpy(), 2.0, rtol=1e-6)


def test_ref_is_the_plain_version():
    x, w = _inputs(3, 300, seed=7)
    a = ref.fedavg_reduce_ref(torch.from_numpy(x), torch.from_numpy(w))
    b = fedavg_reduce_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(a, b)


def test_cpu_call_does_not_count_a_launch():
    before = fedavg_reduce.launches
    x, w = _inputs(4, 1000, seed=3)
    fedavg_reduce(torch.from_numpy(x), torch.from_numpy(w))
    assert fedavg_reduce.launches == before


def test_strided_rows_match_contiguous():
    """The engine's padded-row layout (rows BLOCK-aligned apart) reduces
    like a contiguous buffer."""
    x, w = _inputs(3, 1000, seed=5)
    padded = torch.zeros((3, BLOCK))
    padded[:, :1000] = torch.from_numpy(x)
    view = padded[:, :1000]
    assert view.stride() == (BLOCK, 1)
    assert torch.equal(fedavg_reduce(view, torch.from_numpy(w)),
                       fedavg_reduce(torch.from_numpy(x), torch.from_numpy(w)))


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device that is none of cuda, cpu and
    meta (``meta`` takes the plain version too: the dry-run's route)."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t):
    return torch.Tensor._make_subclass(_Elsewhere, t)


@pytest.mark.parametrize("bad", ["dtype", "weights", "rank", "device"])
def test_fedavg_reduce_rejects_bad_input(bad):
    """Nothing but a CPU or meta tensor reaches the plain version: another
    device raises instead of falling back."""
    x = torch.ones((2, 10))
    w = torch.ones(2)
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "weights":
        w = torch.ones(3)
    elif bad == "rank":
        x = torch.ones(10)
    else:
        x, w = _elsewhere(x), _elsewhere(w)
    with pytest.raises((TypeError, ValueError)):
        fedavg_reduce(x, w)


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one")
    first = _build.build_dir("k")
    assert first.parent == _build.BUILD_ROOT and first.name.startswith("k-")
    (tmp_path / "k.cu").write_text("// two")
    assert _build.build_dir("k") != first


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(["fedavg_reduce"])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "padded_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(layout, dtype):
    """Card only: the CUDA kernel against its plain version on the same
    inputs, for both the vector (padded rows) and scalar (misaligned
    rows, L % 4 != 0) paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = _DTYPES[dtype]
    n, L = 5, 20001
    x, w = _inputs(n, L, seed=11)
    xt = _torch_buffer(x, tdt).cuda()
    if layout == "padded_rows":
        buf = torch.empty((n, -(-L // BLOCK) * BLOCK), dtype=tdt, device="cuda")
        buf[:, :L] = xt
        xt = buf[:, :L]
    wt = torch.from_numpy(w).cuda()
    before = fedavg_reduce.launches
    got = fedavg_reduce(xt, wt)
    torch.cuda.synchronize()
    assert fedavg_reduce.launches == before + 1
    want = fedavg_reduce_plain(xt, wt)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("codec", ["int8", "fp16"])
def test_dequant_fold_kernel_equals_plain_on_card(codec, offset):
    """Card only: the dequant_fold kernel against its plain version on the
    same inputs, bit for bit (both round w*s, (w*s)*x and the sum in fp32,
    in that order), for the vector path (aligned payload) and the scalar
    path (a payload slice one element off 16 bytes).  The accumulator's
    elements past the payload stay as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.dequant_fold import dequant_fold, dequant_fold_plain

    n, lp = 2 * BLOCK + 123, 3 * BLOCK
    gen = torch.Generator(device="cuda").manual_seed(3)
    if codec == "int8":
        buf = torch.randint(-127, 128, (n + offset,), generator=gen, device="cuda",
                            dtype=torch.int8)
        scales = torch.rand(lp // BLOCK, generator=gen, device="cuda") * 1e-2
    else:
        buf = (torch.randn(n + offset, generator=gen, device="cuda") * 1e-2).half()
        scales = torch.ones(lp // BLOCK, device="cuda")
    data = buf[offset:]
    acc = torch.randn(lp, generator=gen, device="cuda")
    got = acc.clone()
    before = dequant_fold.launches
    assert dequant_fold(got, data, scales, 2.5) is got
    torch.cuda.synchronize()
    assert dequant_fold.launches == before + 1
    want = dequant_fold_plain(acc.clone(), data, scales, 2.5)
    assert torch.equal(got, want)
    assert torch.equal(got[n:], acc[n:])
