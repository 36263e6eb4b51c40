"""The pod-parallel FedAvg round: the port's ``make_fl_round_step`` (a loop
over pod replicas, one ``fedavg_reduce`` barrier) against the reference's
``jax.jit``-ed ``jax.vmap`` round.

Both packages start from the reference's ``init_pod_state`` weights
(carried over leaf by leaf) and take the same numpy-seeded batches.  The
families are the reference test's dense config
(``tests/test_federated.py:281``: 2 layers, d_model 32, vocab 61; 2 pods,
3 local steps, per-pod batch 4, seq 16) and reduced mamba2-130m and
granite-moe-1b-a400m in fp32, with SGD-momentum and AdamW, equal and
unequal pod weights (SGD at the reference test's 1e-2, AdamW at
``make_optimizer_for``'s 3e-4).  Tolerances: every parameter and moment
leaf within 1e-5 relative L2 (||port - ref|| / ||ref||, the train-step
tests' measure: AdamW divides by sqrt(v), so single elements at the
rounding floor may step differently), the loss within 1e-5 relative, the
step count exactly.  One exception: the SSM's optimizer moments, sums
of gradients that all run through the SSD scan's backward, are held to
2e-5, the SSD gradient's tolerance against ``jax.vjp`` in
``tests/test_torch_ssd.py`` (measured up to 1.7e-5 here, on the per-head
``A_log``, ``D`` and ``dt_bias``; the reference's own vmap round and its
sequential steps differ by 4.4e-6 in the parameters on the same inputs).  Inside the port the round is
bit-equal to sequential per-pod training followed by ``fedavg_stacked``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federated import init_pod_state as jax_init_pod_state
from repro.federated import make_fl_round_step as jax_round_step
from repro.federated import pod_batch_shape as jax_pod_batch_shape
from repro.launch.steps import make_optimizer_for as jax_optimizer_for
from repro.models import get_model as jax_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.convert import params_from_numpy
from repro_torch.federated import (
    agg_engine,
    fedavg,
    fedavg_stacked,
    init_pod_state,
    make_fl_round_step,
    make_train_step,
    pod_batch_shape,
)
from repro_torch.launch.steps import make_optimizer_for
from repro_torch.models import get_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map

TOL = 1e-5
SSD_GRAD_TOL = 2e-5
N_PODS, LOCAL_STEPS = 2, 3
DENSE = dict(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
             d_ff=64, vocab_size=61, head_dim=16, remat=False, dtype="float32",
             param_dtype="float32")
FAMILIES = ["dense", "mamba2-130m", "granite-moe-1b-a400m"]
OPTIMIZERS = {"sgdm": 1e-2, "adamw": 3e-4}


def _configs(family):
    if family == "dense":
        return JaxModelConfig(**DENSE), ModelConfig(**DENSE)
    kw = dict(dtype="float32", param_dtype="float32")
    return (jax_config(family).reduced().with_overrides(**kw),
            get_config(family).reduced().with_overrides(**kw))


def _layout(tc):
    """(per-pod batch, seq): the reference test's 4 x 16 for dense; two
    SSD chunks for the SSM."""
    if tc.arch_type == "ssm":
        return 2, 2 * tc.ssm_chunk
    return (4, 16) if tc.name == "t" else (2, 16)


def _batches(tc, seed=0):
    per_pod, seq = _layout(tc)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tc.vocab_size, (N_PODS, LOCAL_STEPS, per_pod, seq + 1)).astype(np.int32)
    x, y = toks[..., :-1], toks[..., 1:]
    return ({"tokens": jnp.asarray(x), "labels": jnp.asarray(y)},
            {"tokens": torch.from_numpy(x.copy()), "labels": torch.from_numpy(y.copy())})


@functools.lru_cache(maxsize=None)
def _start(family):
    """The reference's stacked start, and the same weights in the port."""
    jc, tc = _configs(family)
    jm, tm = jax_model(jc), get_model(tc)
    jsp, _ = jax_init_pod_state(jm, jax_make_optimizer("sgdm", 1e-2), jax.random.PRNGKey(0),
                                N_PODS)
    return jc, tc, jm, tm, jsp


def _port_start(family, opt_name):
    jc, tc, jm, tm, jsp = _start(family)
    tsp = params_from_numpy(jax.tree.map(np.asarray, jsp), "cpu")
    topt = make_optimizer(opt_name, OPTIMIZERS[opt_name])
    return tc, tm, tsp, topt, topt.init(tsp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_close(got, want, tol=TOL):
    pairs, jleaves = tree_flatten_with_path(got)[0], jax.tree.leaves(want)
    assert len(pairs) == len(jleaves)
    for (path, a), b in zip(pairs, jleaves):
        assert tuple(a.shape) == b.shape
        err = _rel_l2(a.numpy(), b)
        assert err <= tol, f"{'/'.join(map(str, path))}: {err:.3e}"


@pytest.mark.parametrize("weights", [None, (1.0, 3.0)], ids=["equal", "w13"])
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("family", FAMILIES)
def test_round_matches_reference_vmap_round(family, opt_name, weights):
    jc, tc, jm, tm, jsp = _start(family)
    _, _, tsp, topt, tso = _port_start(family, opt_name)
    jopt = jax_make_optimizer(opt_name, OPTIMIZERS[opt_name])
    jso = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N_PODS,) + x.shape),
                       jopt.init(jax.tree.map(lambda x: x[0], jsp)))
    jb, tb = _batches(tc)
    jw = None if weights is None else jnp.asarray(weights, jnp.float32)
    jp, jo, jloss = jax.jit(jax_round_step(jm, jopt, LOCAL_STEPS, pod_weights=jw))(jsp, jso, jb)
    tp, to, tloss = make_fl_round_step(tm, topt, LOCAL_STEPS, pod_weights=weights)(tsp, tso, tb)

    assert tloss.dtype == torch.float32 and tloss.shape == ()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    _assert_close(tp, jp)
    moment_tol = SSD_GRAD_TOL if tc.arch_type == "ssm" else TOL
    if opt_name == "adamw":
        _assert_close(to.m, jo.m, moment_tol)
        _assert_close(to.v, jo.v, moment_tol)
    else:
        _assert_close(to.momentum, jo.momentum, moment_tol)
    assert isinstance(to.step, int)
    assert all(int(s) == to.step for s in np.asarray(jo.step))


def _sequential_then_stacked(tm, topt, tsp, tso, tb, weights):
    """Each pod trains alone from its slice of the start, then
    ``fedavg_stacked`` folds the finals: the reference's own property."""
    step = make_train_step(tm, topt)
    finals = []
    for pod in range(N_PODS):
        p = tree_map(lambda x: x[pod], tsp)
        o = type(tso)(tso.step, *(tree_map(lambda x: x[pod], t) for t in tso[1:]))
        for s in range(LOCAL_STEPS):
            p, o, _ = step(p, o, {k: v[pod, s] for k, v in tb.items()})
        finals.append(p)
    stacked = tree_map(lambda *xs: torch.stack(xs), *finals)
    return finals, fedavg_stacked(stacked, torch.tensor(weights, dtype=torch.float32))


def _bit_equal(a, b):
    return torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("family", ["dense", "mamba2-130m"])
def test_round_bit_equal_to_sequential_then_fedavg_stacked(family, opt_name):
    tc, tm, tsp, topt, tso = _port_start(family, opt_name)
    _, tb = _batches(tc, seed=1)
    w = (2.0, 5.0)
    finals, want = _sequential_then_stacked(tm, topt, tsp, tso, tb, w)
    got, _, _ = make_fl_round_step(tm, topt, LOCAL_STEPS, pod_weights=w)(tsp, tso, tb)
    for g, a in zip(tree_leaves(got), tree_leaves(want)):
        for pod in range(N_PODS):
            assert _bit_equal(g[pod], a)
    # The barrier against the per-leaf oracle (fp32: 2e-5).
    oracle = fedavg(finals, w)
    for a, o in zip(tree_leaves(want), tree_leaves(oracle)):
        assert (a - o).abs().max().item() <= 2e-5 * max(1.0, o.abs().max().item())


@pytest.mark.parametrize("family", FAMILIES)
def test_pods_bit_equal_after_the_barrier(family):
    tc, tm, tsp, topt, tso = _port_start(family, "adamw")
    _, tb = _batches(tc, seed=2)
    got, new_opt, _ = make_fl_round_step(tm, topt, LOCAL_STEPS)(tsp, tso, tb)
    for leaf in tree_leaves(got):
        assert leaf.shape[0] == N_PODS
        assert all(_bit_equal(leaf[p], leaf[0]) for p in range(1, N_PODS))
        assert leaf.untyped_storage().data_ptr() not in (
            t.untyped_storage().data_ptr() for t in tree_leaves(tsp))
    # The moments stay per pod: the pods trained on different batches.
    assert not torch.equal(tree_leaves(new_opt.m)[0][0], tree_leaves(new_opt.m)[0][1])
    assert new_opt.step == LOCAL_STEPS


def test_round_leaves_its_inputs_untouched():
    tc, tm, tsp, topt, tso = _port_start("dense", "adamw")
    _, tb = _batches(tc, seed=3)
    before = [x.clone() for x in tree_leaves(tsp) + tree_leaves(tso.m) + tree_leaves(tso.v)
              + list(tb.values())]
    make_fl_round_step(tm, topt, LOCAL_STEPS)(tsp, tso, tb)
    after = tree_leaves(tsp) + tree_leaves(tso.m) + tree_leaves(tso.v) + list(tb.values())
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert tso.step == 0


def test_one_fedavg_reduce_call_a_round(monkeypatch):
    calls = []
    real = agg_engine.fedavg_reduce

    def counting(stacked, w):
        calls.append(tuple(stacked.shape))
        return real(stacked, w)

    monkeypatch.setattr(agg_engine, "fedavg_reduce", counting)
    tc, tm, tsp, topt, tso = _port_start("dense", "sgdm")
    _, tb = _batches(tc, seed=4)
    step = make_fl_round_step(tm, topt, LOCAL_STEPS)
    p, o, _ = step(tsp, tso, tb)
    assert len(calls) == 1
    n = sum(leaf[0].numel() for leaf in tree_leaves(tsp))
    assert calls == [(N_PODS, n)]
    step(p, o, tb)
    assert len(calls) == 2


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_init_pod_state_and_batch_shapes_match_reference(arch):
    """Full size, abstract: the reference's ``init_pod_state`` under
    ``jax.eval_shape`` against the port's on the ``meta`` device, with
    each config's ``make_optimizer_for``; and ``pod_batch_shape``."""
    jc, tc = jax_config(arch), get_config(arch)
    jopt, topt = jax_optimizer_for(jc), make_optimizer_for(tc)
    jp, jo = jax.eval_shape(
        lambda: jax_init_pod_state(jax_model(jc), jopt, jax.random.PRNGKey(0), 2))
    tp, to = init_pod_state(get_model(tc), topt, torch.Generator(), 2, device="meta")

    def same(t, j):
        tl, jl = tree_leaves(t), jax.tree.leaves(j)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert a.device.type == "meta"
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)

    same(tp, jp)
    same(to.m, jo.m)
    same(to.v, jo.v)
    assert to.step == 0 and jo.step.shape == (2,)
    for args in [(2, 4, 4, 2048), (2, 1, 8, 64)]:
        want = jax_pod_batch_shape(jc, *args)
        got = pod_batch_shape(tc, *args)
        assert list(got) == list(want)
        for k in want:
            assert got[k][0] == want[k][0]
            assert str(got[k][1]).removeprefix("torch.") == jnp.dtype(want[k][1]).name
