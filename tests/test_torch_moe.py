"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, from the same weights: the reference's
``init_moe`` drawn with a JAX key and carried over by
``params_from_numpy``, inputs from a numpy seed.

Reduced granite-moe-1b-a400m (4 experts, top 2) and deepseek-moe-16b (the
same with a shared expert).  Tolerances, absolute and relative: fp32
outputs 1e-5 (the same fp32 arithmetic, summed in other orders); bf16 2e-2
(``tests/test_kernels.py``'s: the port sums a token's K expert rows in
fp32 and rounds once, the reference rounds after each add); the
auxiliary loss 1e-6; fp32 gradients against ``jax.vjp`` 1e-4.  Expert
choices and keep masks are equal, including where experts overflow.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as M
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(arch, dtype="float32", seed=0):
    kw = dict(dtype=dtype, param_dtype=dtype)
    jc = jax_config(arch).reduced().with_overrides(**kw)
    tc = get_config(arch).reduced().with_overrides(**kw)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(jc, tc, batch, seq, seed=1):
    x = np.random.default_rng(seed).standard_normal((batch, seq, tc.d_model)).astype(np.float32)
    return jnp.asarray(x, jc.activation_dtype), torch.from_numpy(x).to(tc.activation_dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _jax_routing(jp, jx, cfg, capacity_factor):
    """The reference's routing steps (``repro/models/moe.py:apply_moe``),
    G = 1: expert indices (T, K) and the keep mask (T·K,)."""
    E, K = cfg.n_experts, cfg.top_k
    T = jx.shape[0] * jx.shape[1]
    probs = JM.router_probs(jp, jx.reshape(T, -1))
    _, idx = jax.lax.top_k(probs, K)
    capacity = max(int(math.ceil(K * T / E * capacity_factor)), min(T, 8))
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot, flat[:, None], 1)[:, 0]
    return np.asarray(idx), np.asarray(pos < capacity), capacity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype):
    jc, tc, jp, tp = _pair(arch, dtype)
    assert ("shared" in tp) == (arch == "deepseek-moe-16b")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tp.items() if k != "shared"} == \
        {k: (v.shape, str(v.dtype)) for k, v in jp.items() if k != "shared"}
    assert tp["router"].dtype == torch.float32
    jx, tx = _x(jc, tc, 2, 24)
    jy, jaux = JM.apply_moe(jp, jx, jc)
    ty, taux = M.apply_moe(tp, tx, tc)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == jy.shape
    assert taux.dtype == torch.float32 and taux.shape == ()
    _close(ty, jy, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_overflow_drops_the_reference_assignments(arch):
    """capacity_factor 0.25: experts overflow, and the port keeps and drops
    exactly the reference's assignments (earlier (token, k) pairs win)."""
    jc, tc, jp, tp = _pair(arch)
    jx, tx = _x(jc, tc, 2, 24, seed=2)
    idx, keep, capacity = _jax_routing(jp, jx, jc, 0.25)
    r = M.route(tp, tx.reshape(48, -1), tc, 0.25)
    assert r.capacity == capacity == 8          # the floor min(T, 8) over ceil(6.0)
    assert np.array_equal(r.expert_idx.numpy(), idx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert 0 < (~keep).sum() < keep.size
    jy, jaux = JM.apply_moe(jp, jx, jc, capacity_factor=0.25)
    ty, taux = M.apply_moe(tp, tx, tc, capacity_factor=0.25)
    _close(ty, jy, TOL["float32"])
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sized_batch_is_drop_free(arch):
    """T = 4 tokens: the capacity floor min(T, 8) keeps every assignment."""
    jc, tc, jp, tp = _pair(arch)
    jx, tx = _x(jc, tc, 4, 1, seed=3)
    idx, keep, capacity = _jax_routing(jp, jx, jc, jc.moe_capacity_factor)
    r = M.route(tp, tx.reshape(4, -1), tc, tc.moe_capacity_factor)
    assert r.capacity == capacity == 4
    assert keep.all() and bool(r.keep.all())
    assert np.array_equal(r.expert_idx.numpy(), idx)
    jy, _ = JM.apply_moe(jp, jx, jc)
    ty, _ = M.apply_moe(tp, tx, tc)
    _close(ty, jy, TOL["float32"])


def _grads(tp, tx, tc, dy, daux, capacity_factor=None):
    leaves, treedef = tree_flatten(tp)
    live = [t.detach().requires_grad_(True) for t in leaves]
    x = tx.detach().requires_grad_(True)
    y, aux = M.apply_moe(tree_unflatten(treedef, live), x, tc, capacity_factor)
    out = torch.autograd.grad((y * dy).sum() + aux * daux, [x] + live)
    return y.detach(), out


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_matches_jax_vjp(arch, capacity_factor):
    """fp32: the gradient with respect to x and every leaf (router, experts,
    shared expert) against ``jax.vjp`` of the reference, with and without
    drops."""
    jc, tc, jp, tp = _pair(arch)
    jx, tx = _x(jc, tc, 2, 24, seed=4)
    dy = np.random.default_rng(5).standard_normal(tuple(tx.shape)).astype(np.float32)
    daux = 0.7
    (jy, jaux), vjp = jax.vjp(lambda p, x: JM.apply_moe(p, x, jc, capacity_factor), jp, jx)
    jgp, jgx = vjp((jnp.asarray(dy), jnp.float32(daux)))
    _, (gx, *gp) = _grads(tp, tx, tc, torch.from_numpy(dy), daux, capacity_factor)
    _close(gx, jgx, 1e-4)
    jleaves = jax.tree.leaves(jgp)
    assert len(gp) == len(jleaves)
    for g, jg in zip(gp, jleaves):
        assert tuple(g.shape) == jg.shape
        _close(g, jg, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_cpu_calls_are_bit_equal(dtype):
    jc, tc, _, tp = _pair("deepseek-moe-16b", dtype)
    _, tx = _x(jc, tc, 2, 24, seed=6)
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(tuple(tx.shape))).to(tx.dtype)
    (y1, g1), (y2, g2) = (_grads(tp, tx, tc, dy, 0.5, 0.5) for _ in range(2))
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu_and_repeats_bit_for_bit(arch, dtype):
    """Card only: the forward and gradient on the card against the CPU
    (fp32 1e-4; bf16 2e-2 for y, 2e-2 relative L2 a gradient), with equal
    expert choices and keep masks at capacity_factor 0.5 (drops), and two
    card calls bit-equal in the forward and every gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    jc, tc, _, tp = _pair(arch, dtype)
    _, tx = _x(jc, tc, 4, 64, seed=8)
    dy = torch.from_numpy(np.random.default_rng(9).standard_normal(tuple(tx.shape))).to(tx.dtype)
    cpu = _grads(tp, tx, tc, dy, 0.5, 0.5)
    cp, cx, cdy = tree_map(lambda t: t.cuda(), tp), tx.cuda(), dy.cuda()
    card = _grads(cp, cx, tc, cdy, 0.5, 0.5)
    again = _grads(cp, cx, tc, cdy, 0.5, 0.5)
    r_cpu = M.route(tp, tx.reshape(256, -1), tc, 0.5)
    r_card = M.route(cp, cx.reshape(256, -1), tc, 0.5)
    assert torch.equal(r_card.expert_idx.cpu(), r_cpu.expert_idx)
    assert torch.equal(r_card.keep.cpu(), r_cpu.keep) and not bool(r_cpu.keep.all())
    assert torch.equal(card[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(card[1], again[1]))
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-4
    _close(card[0].cpu(), cpu[0].float().numpy(), tol)
    for a, b in zip(card[1], cpu[1]):
        if dtype == "float32":
            _close(a.cpu(), b.numpy(), 1e-4)
        else:
            a, b = a.cpu().double(), b.double()
            assert ((a - b).norm() / b.norm()).item() <= 2e-2
