"""Card-only tests of the AdamW kernel (``kernels/adamw.py``,
``csrc/adamw_step.cu``): bit for bit the plain version run on the same
card, in every (parameter, state) dtype pair the port allows.

This file imports no JAX, so it collects on the card's machine with
``--noconftest``; every test is marked ``gpu`` and skips without a card.
The plain version's own tests (and the rule against the reference's) are
the CPU tests in ``tests/test_torch_optim.py``.
"""
import itertools
import math

import pytest
import torch

from repro_torch.kernels import adamw, ops
from repro_torch.optim import AdamW, masked, optimizers, warmup_cosine
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
TABLE = 48   # leaves a launch takes: kMaxLeaves in csrc/adamw_step.cu
HYPER = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield
    spans.disable()
    spans.take()


def _randn(n, dtype, gen, scale=1.0):
    return (torch.randn(n, generator=gen, device="cuda") * scale).to(dtype)


def _leaves(sizes, p_dt, s_dt, seed=0):
    """Parameters, gradients (scales from 1e-4 to 1e2, so sqrt(v) and eps
    both matter) and moments as a few steps leave them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = [_randn(n, p_dt, gen) for n in sizes]
    g = [_randn(n, p_dt, gen, 10.0 ** (k % 7 - 4)) for k, n in enumerate(sizes)]
    m = [_randn(n, s_dt, gen, 0.1) for n in sizes]
    v = [(_randn(n, torch.float32, gen, 0.01) ** 2).to(s_dt) for n in sizes]
    return p, g, m, v


def _bit_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _step(step, b1=HYPER["b1"], b2=HYPER["b2"]):
    import numpy as np

    f = np.float32
    return dict(c1=float(f(1.0) - f(b1) ** f(step)), c2=float(f(1.0) - f(b2) ** f(step)))


@pytest.mark.parametrize("p_dt,s_dt", list(itertools.product(DTYPES, DTYPES)))
def test_kernel_bit_equal_to_plain_every_dtype_pair(p_dt, s_dt):
    """Sizes 1, 7, 4,097 and 2^24 + 3 (ragged vector tails and chunk
    ends), at steps 1 and 5: one launch for the pair's group."""
    sizes = (1, 7, 4097, (1 << 24) + 3)
    p, g, m, v = _leaves(sizes, p_dt, s_dt)
    for step in (1, 5):
        kw = dict(lr=HYPER["lr"], b1=HYPER["b1"], b2=HYPER["b2"], eps=HYPER["eps"],
                  weight_decay=HYPER["weight_decay"], **_step(step))
        before = ops.adamw_step.launches
        got = ops.adamw_step(p, g, m, v, **kw)
        assert ops.adamw_step.launches == before + 1
        want = adamw.adamw_step_plain(p, g, m, v, **kw)
        torch.cuda.synchronize()
        _bit_equal(got, want)


@pytest.mark.parametrize("p_dt", [torch.float32, torch.bfloat16])
def test_kernel_on_views_at_odd_offsets(p_dt):
    """Leaves that are views into flat buffers at odd element offsets (the
    unflattened global tree) go element by element, bit-equal too, beside
    aligned leaves and a transposed one in the same launch; the inputs are
    left as they were."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 100_003
    flat = [_randn(3 * n + 8, p_dt, gen) for _ in range(2)]
    p = [flat[0][1:1 + n], flat[0][n + 3:2 * n + 3], _randn(n, p_dt, gen),
         _randn((64, 33), p_dt, gen).t()]
    g = [flat[1][5:5 + n], flat[1][n + 9:2 * n + 9], _randn(n, p_dt, gen),
         _randn((64, 33), p_dt, gen).t()]
    m = [_randn(t.shape, torch.float32, gen, 0.1) for t in p]
    v = [(_randn(t.shape, torch.float32, gen, 0.01) ** 2) for t in p]
    copies = [t.clone() for t in p + g + m + v]
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, **_step(2))
    before = ops.adamw_step.launches
    got = ops.adamw_step(p, g, m, v, **kw)
    assert ops.adamw_step.launches == before + 1
    _bit_equal(got, adamw.adamw_step_plain(p, g, m, v, **kw))
    for a, b in zip(p + g + m + v, copies):
        assert torch.equal(a, b)


def test_more_leaves_than_one_table():
    """120 leaves of one group take ceil(120 / 48) = 3 launches, bit-equal;
    empty leaves launch nothing and come back empty."""
    sizes = [1 + (k * 7919) % 20_000 for k in range(120)]
    p, g, m, v = _leaves(sizes, torch.bfloat16, torch.float32, seed=5)
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, **_step(1))
    before = ops.adamw_step.launches
    got = ops.adamw_step(p, g, m, v, **kw)
    assert ops.adamw_step.launches == before + math.ceil(len(sizes) / TABLE)
    _bit_equal(got, adamw.adamw_step_plain(p, g, m, v, **kw))
    empty = [torch.empty(0, 3, device="cuda", dtype=torch.bfloat16)]
    before = ops.adamw_step.launches
    out = ops.adamw_step(empty, empty, [empty[0].float()], [empty[0].float()], **kw)
    assert ops.adamw_step.launches == before and out[0][0].shape == (0, 3)


def _tree(seed):
    """A mamba2-like tree: bf16 matrices and fp32 vectors, a 0-d leaf."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {
        "emb": _randn((1000, 64), torch.bfloat16, gen),
        "layers": {"w": _randn((3, 64, 96), torch.bfloat16, gen),
                   "A_log": _randn((3, 8), torch.float32, gen),
                   "D": _randn((3, 8), torch.float32, gen)},
        "scale": torch.tensor(0.5, device="cuda"),
    }


def _grads(tree, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: _grads(t, seed + 1) if isinstance(t, dict) else
            _randn(t.shape, t.dtype, gen, 0.3) for k, t in tree.items()}


def _run(opt, steps, plain, monkeypatch):
    params = _tree(0)
    state = opt.init(params)
    with monkeypatch.context() as mp:
        if plain:
            mp.setattr(optimizers.ops, "adamw_step", adamw.adamw_step_plain)
        for s in range(steps):
            params, state = opt.update(_grads(params, 100 + s), state, params)
    return params, state


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_five_steps_bit_equal(state_dtype, schedule, monkeypatch):
    """``AdamW.update`` over a tree of two dtypes, 5 steps, with and without
    an lr schedule: bit-equal to the plain version on the card after every
    step count; two launches a step (the bf16 and the fp32 group), and the
    counter holds every element each step."""
    sched = warmup_cosine(1e-2, 2, 10) if schedule else None
    opt = AdamW(learning_rate=1e-3, state_dtype=state_dtype, schedule=sched)
    n = sum(t.numel() for t in tree_leaves(_tree(0)))
    for steps in (1, 5):
        want = _run(opt, steps, True, monkeypatch)
        before = ops.adamw_step.launches
        spans.enable()
        with spans.span("fl.round", round=1):
            got = _run(opt, steps, False, monkeypatch)
        spans.disable()
        taken = spans.take()
        assert ops.adamw_step.launches == before + 2 * steps
        assert taken.counters["optim.adamw.fused_elems"] == {1: n * steps}
        assert [s.name for s in taken.spans].count("optim.update") == steps
        assert got[1].step == want[1].step == steps
        _bit_equal([got[0], got[1].m, got[1].v], [want[0], want[1].m, want[1].v])


def test_masked_optimizer_through_the_kernel(monkeypatch):
    """LoRA's route: ``masked(AdamW)`` hands only the trained leaves to the
    kernel; frozen leaves come back as the same tensors."""
    opt = masked(AdamW(learning_rate=1e-3), lambda path: "w" in path or "D" in path)
    want = _run(opt, 3, True, monkeypatch)
    params = _tree(0)
    before = ops.adamw_step.launches
    got = _run(opt, 3, False, monkeypatch)
    assert ops.adamw_step.launches == before + 2 * 3
    _bit_equal(tree_leaves(got[0]), tree_leaves(want[0]))
    _bit_equal([got[1].m, got[1].v], [want[1].m, want[1].v])
    assert torch.equal(got[0]["emb"], params["emb"]) and torch.equal(got[0]["scale"],
                                                                      params["scale"])


def test_pytorch_divides_by_a_scalar_through_its_fp32_reciprocal():
    """The premise of ``_scalars``: on the card ``x / c`` for a Python
    float ``c`` is ``x * (1.0f / float(c))``, not a true division."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(1 << 20, generator=gen, device="cuda")
    for c in (0.1, 0.0975, 1 - 0.95 ** 3, 0.05):
        inv = float(np.float32(1.0) / np.float32(c))
        assert torch.equal(x / c, x * inv)
