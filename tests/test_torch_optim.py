"""The port's optimizers and schedules against the reference's, on the
same tree and the same gradient sequence (numpy, seeded).  Both do the
update in fp32 with the same formula, so parameters and state agree to
1e-6 after several steps (the last digits differ only where the two
frameworks round sqrt and division differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JaxAdamW
from repro.optim import SGDMomentum as JaxSGDM
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.optim import AdamW, SGDMomentum, make_optimizer, warmup_cosine
from repro_torch.utils.tree import tree_leaves

_SHAPES = {"fc": {"w": (6, 5), "b": (5,)}, "emb": (7, 3), "scalar": ()}


def _tree(rng, scale=1.0):
    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        return np.asarray(rng.standard_normal(s) * scale, np.float32)
    return build(_SHAPES)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _run(jax_opt, port_opt, n_steps=6, seed=0):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** rng.integers(-3, 1)) for _ in range(n_steps)]
    jp = _to(p0, jnp.asarray)
    tp = _to(p0, torch.from_numpy)
    js, ts = jax_opt.init(jp), port_opt.init(tp)
    for g in grads:
        jp, js = jax_opt.update(_to(g, jnp.asarray), js, jp)
        tp, ts = port_opt.update(_to(g, torch.from_numpy), ts, tp)
    return jp, js, tp, ts


def _close(torch_tree, jax_tree, tol):
    for t, j in zip(tree_leaves(torch_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("kw", [
    {},
    {"learning_rate": 1e-2, "weight_decay": 0.0},
    {"learning_rate": 5e-3, "b1": 0.8, "b2": 0.99, "eps": 1e-6},
])
def test_adamw_matches_reference(kw):
    jp, js, tp, ts = _run(JaxAdamW(**kw), AdamW(**kw))
    _close(tp, jp, 1e-6)
    _close(ts.m, js.m, 1e-6)
    _close(ts.v, js.v, 1e-6)
    assert ts.step == int(js.step)


def test_adamw_with_schedule_matches_reference():
    jopt = JaxAdamW(learning_rate=0.0, schedule=jax_warmup_cosine(1e-2, 2, 6))
    topt = AdamW(learning_rate=0.0, schedule=warmup_cosine(1e-2, 2, 6))
    jp, _, tp, _ = _run(jopt, topt)
    _close(tp, jp, 1e-6)


@pytest.mark.parametrize("kw", [{}, {"learning_rate": 0.1, "momentum": 0.5}])
def test_sgdm_matches_reference(kw):
    jp, js, tp, ts = _run(JaxSGDM(**kw), SGDMomentum(**kw))
    _close(tp, jp, 1e-6)
    _close(ts.momentum, js.momentum, 1e-6)


def test_warmup_cosine_values():
    j, t = jax_warmup_cosine(3e-3, 10, 100, 0.1), warmup_cosine(3e-3, 10, 100, 0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(t(s), float(j(jnp.asarray(s))), rtol=1e-6)


def test_update_is_out_of_place():
    """The global tree handed to a client must not change under it."""
    p = {"w": torch.ones(3)}
    opt = AdamW(learning_rate=0.1)
    new, _ = opt.update({"w": torch.ones(3)}, opt.init(p), p)
    assert torch.equal(p["w"], torch.ones(3)) and not torch.equal(new["w"], p["w"])


def test_make_optimizer():
    assert isinstance(make_optimizer("adamw", 1e-3), AdamW)
    opt = make_optimizer("sgdm", 1e-2, momentum=0.5)
    assert isinstance(opt, SGDMomentum) and opt.momentum == 0.5
    assert AdamW().b2 == 0.95 and AdamW().weight_decay == 0.1
    with pytest.raises(ValueError):
        make_optimizer("lion", 1e-3)
