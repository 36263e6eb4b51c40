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


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_by_slices_is_bit_equal_to_whole_leaves(state_dtype, monkeypatch):
    """AdamW's plain version updates a leaf a slice at a time; slices of
    333 elements (leaves of 37,000, 5 and a transposed 4 x 3) give the same
    bits as slices larger than every leaf."""
    from repro_torch.kernels import adamw

    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(1000, 37, generator=g).bfloat16(), "b": torch.randn(5, generator=g),
              "c": torch.randn(3, 4, generator=g).t()}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in params.items()}
    opt = AdamW(state_dtype=state_dtype)
    state = opt.init(params)
    state = state._replace(
        m={k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in state.m.items()},
        v={k: torch.rand(v.shape, generator=g).to(v.dtype) for k, v in state.v.items()})
    whole = opt.update(grads, state, params)
    monkeypatch.setattr(adamw, "_UPDATE_SLICE", 333)
    sliced = opt.update(grads, state, params)
    for a, b in zip(*(tree_leaves([p, st.m, st.v]) for p, st in (whole, sliced))):
        assert a.shape == b.shape and torch.equal(a, b)


def _leaves(device, dtype=torch.float32, state=torch.float32, n=(37, 5)):
    g = torch.Generator().manual_seed(1)
    p = [torch.randn(k, generator=g).to(device=device, dtype=dtype) for k in n]
    grads = [torch.randn(k, generator=g).to(device=device, dtype=dtype) for k in n]
    m = [torch.randn(k, generator=g).to(device=device, dtype=state) for k in n]
    v = [torch.rand(k, generator=g).to(device=device, dtype=state) for k in n]
    return p, grads, m, v


_HYPER = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, c1=0.1, c2=0.05)


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16])
def test_adamw_step_cpu_takes_the_plain_version(state, monkeypatch):
    """CPU leaves go through ``adamw_step_plain`` (bit for bit) and build
    and launch nothing; so does ``AdamW.update`` on a CPU tree."""
    from repro_torch.kernels import _build, adamw, ops

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU call")

    monkeypatch.setattr(_build, "load", no_build)
    before = ops.adamw_step.launches
    p, g, m, v = _leaves("cpu", torch.bfloat16, state)
    got = ops.adamw_step(p, g, m, v, **_HYPER)
    want = adamw.adamw_step_plain(p, g, m, v, **_HYPER)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [t.dtype for t in got[1]] == [state, state]
    opt = AdamW(state_dtype="bfloat16" if state == torch.bfloat16 else "float32")
    tree = {"a": p[0], "b": p[1]}
    new, st = opt.update({"a": g[0], "b": g[1]}, opt.init(tree), tree)
    assert st.m["a"].dtype == state and new["a"].dtype == torch.bfloat16
    assert ops.adamw_step.launches == before


def test_adamw_step_meta_takes_the_plain_version(monkeypatch):
    """``meta`` leaves (the dry-run's) come back with their shapes and
    dtypes, and nothing is built or launched."""
    from repro_torch.kernels import _build, ops

    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    before = ops.adamw_step.launches
    params = {"w": torch.empty(3, 1 << 25, device="meta", dtype=torch.bfloat16),
              "b": torch.empty(4, device="meta")}
    opt = AdamW()
    new, st = opt.update({k: torch.empty_like(t) for k, t in params.items()},
                         opt.init(params), params)
    assert all(t.device.type == "meta" for t in tree_leaves([new, st.m, st.v]))
    assert new["w"].shape == (3, 1 << 25) and new["w"].dtype == torch.bfloat16
    assert st.m["w"].dtype == torch.float32 and st.step == 1
    assert ops.adamw_step.launches == before


def _mismatched(case):
    p, g, m, v = _leaves("cpu")
    if case == "shape":
        g[1] = g[1][:4]
    elif case == "grad dtype":
        g[0] = g[0].double()
    elif case == "moment dtypes":
        v[1] = v[1].bfloat16()
    elif case == "device":
        m[1] = torch.empty(m[1].shape, device="meta")
    elif case == "count":
        v = v[:1]
    return p, g, m, v


@pytest.mark.parametrize("case,exc", [("shape", ValueError), ("grad dtype", TypeError),
                                      ("moment dtypes", TypeError), ("device", ValueError),
                                      ("count", ValueError)])
def test_adamw_step_refuses_mismatched_leaves(case, exc):
    from repro_torch.kernels import ops

    before = ops.adamw_step.launches
    with pytest.raises(exc):
        ops.adamw_step(*_mismatched(case), **_HYPER)
    assert ops.adamw_step.launches == before


def test_adamw_update_span_and_no_fused_count_on_cpu():
    """With spans on, each ``AdamW.update`` records ``optim.update`` (under
    the caller's span, in its round); the fused-elements counter, which
    only the kernel adds to, stays absent on the CPU."""
    from repro_torch.utils import spans

    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    opt = AdamW()
    state = opt.init(params)
    spans.enable()
    try:
        with spans.span("fl.round", round=4):
            for _ in range(2):
                params, state = opt.update({"w": torch.ones(3, 2), "b": torch.ones(2)},
                                           state, params)
    finally:
        spans.disable()
    taken = spans.take()
    names = [s.name for s in taken.spans]
    assert names == ["fl.round", "optim.update", "optim.update"]
    assert all(s.parent == 0 and s.round == 4 and s.end_ns >= s.start_ns
               for s in taken.spans[1:])
    assert "optim.adamw.fused_elems" not in taken.counters
