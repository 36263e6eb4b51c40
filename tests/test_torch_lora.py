"""The port's federated-LoRA pieces against the reference's: the adapter
helpers (``inject_lora``, ``lora_effective``, ``merge_lora``, the schema
and the merge hook), the masked optimizer, the client's train step under
it, and the conversion of injected trees.

Adapters injected by the reference are carried to the port by path
(:mod:`repro_torch.convert`), not re-drawn: the two packages' generators
give different numbers from one seed.  Tolerances: 1e-6 relative where
the two compute the same fp32 expression, 1e-6 for an optimizer step on
the same gradients (fp32 math in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import fl_models as jm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import masked as jax_masked
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.fl_models import (
    LORA_A_SUFFIX,
    LORA_B_SUFFIX,
    LoRAConfig,
    inject_lora,
    lora_adapter_schema,
    lora_effective,
    lora_merge_hook,
    merge_lora,
)
from repro_torch.optim import MaskedOptimizer, make_optimizer, masked
from repro_torch.utils.tree import keystr, tree_flatten, tree_flatten_with_path


def _base_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "fc0": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                "b": rng.standard_normal(3).astype(np.float32)},
        "head": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                 "b": np.zeros(2, np.float32)},
        "stack": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32)},
        "ints": {"w": np.arange(6, dtype=np.int32).reshape(2, 3)},
    }


def _injected(cfg, seed=0):
    """The reference injects; both packages get its tree."""
    jtree = jm.inject_lora(jax.tree.map(jnp.asarray, _base_np(seed)),
                           jax.random.PRNGKey(1), cfg)
    return jtree, params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _close(got, want, tol=1e-6):
    leaves = tree_flatten(got)[0]
    jleaves = jax.tree.leaves(want)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)


def test_inject_lora_layout_matches_reference():
    """Same keys, shapes and dtypes (so plans and schema signatures agree);
    ``a`` N(0, 0.01), ``b`` zeros, fp32; int leaves and non-targets skipped."""
    cfg = LoRAConfig(rank=2, alpha=4.0, targets=("w",))
    jtree, _ = _injected(cfg)
    got = inject_lora(params_from_numpy(_base_np(), device="cpu"),
                      torch.Generator().manual_seed(1), cfg)
    pairs = [(keystr(p), tuple(x.shape), str(x.dtype)[6:]) for p, x in tree_flatten_with_path(got)[0]]
    jpairs = [(jax.tree_util.keystr(p), x.shape, x.dtype.name)
              for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert pairs == jpairs
    assert set(got["fc0"]) == {"w", "b", "w.lora_a", "w.lora_b"}
    assert "w.lora_a" not in got["ints"]
    assert got["stack"]["w.lora_a"].shape == (2, 4, 2) and got["stack"]["w.lora_b"].shape == (2, 2, 3)
    assert not got["fc0"]["w.lora_b"].any()
    a = torch.cat([got[k]["w" + LORA_A_SUFFIX].reshape(-1) for k in ("fc0", "head", "stack")])
    assert 0.003 < float(a.std()) < 0.03
    from repro_torch.federated.agg_engine import UpdateSchema

    assert UpdateSchema({"adapters": ".lora_"}).resolve(got).signature == \
        jm.lora_adapter_schema().resolve(jtree).signature
    with pytest.raises(ValueError, match="nothing injected"):
        inject_lora(got, torch.Generator(), LoRAConfig(rank=2, targets=("nope",)))
    with pytest.raises(ValueError, match="rank"):
        LoRAConfig(rank=0)


def test_effective_merge_and_hook_match_reference():
    cfg = LoRAConfig(rank=2, alpha=4.0, targets=("w",))
    jtree, tree = _injected(cfg)
    # Zero b: the effective weights equal the base bit for bit.
    eff0 = lora_effective(tree, cfg)
    assert torch.equal(eff0["fc0"]["w"], tree["fc0"]["w"])
    # Move b in both packages.
    rng = np.random.default_rng(3)
    moved_np = jax.tree.map(np.asarray, jtree)
    for k in ("fc0", "head", "stack"):
        moved_np[k]["w" + LORA_B_SUFFIX] = rng.standard_normal(
            moved_np[k]["w" + LORA_B_SUFFIX].shape).astype(np.float32)
    moved, jmoved = params_from_numpy(moved_np, device="cpu"), jax.tree.map(jnp.asarray, moved_np)
    _close(lora_effective(moved, cfg), jm.lora_effective(jmoved, cfg))
    merged, jmerged = merge_lora(moved, cfg), jm.merge_lora(jmoved, cfg)
    _close(merged, jmerged)
    assert not merged["stack"]["w" + LORA_B_SUFFIX].any()
    # merging keeps the effective weights
    _close(lora_effective(merged, cfg), jm.lora_effective(jmerged, cfg))
    for k in ("fc0", "head", "stack"):
        np.testing.assert_allclose(lora_effective(merged, cfg)[k]["w"].numpy(),
                                   np.asarray(jm.lora_effective(jmoved, cfg)[k]["w"]),
                                   rtol=1e-5, atol=1e-5)
    hook = lora_merge_hook(cfg, every=2)
    assert hook(1, moved) is None
    _close(hook(2, moved), jmerged)
    assert lora_merge_hook(cfg, every=0)(4, moved) is None
    assert lora_merge_hook(LoRAConfig(merge_every=3))(3, moved) is not None
    resolved = lora_adapter_schema().resolve(tree)
    assert resolved.group("adapters").total_elems == (5 * 2 + 2 * 3) + (3 * 2 + 2 * 2) + \
        (2 * 4 * 2 + 2 * 2 * 3)


def test_lora_effective_is_differentiable_to_the_factors():
    cfg = LoRAConfig(rank=2, alpha=4.0, targets=("w",))
    jtree, tree = _injected(cfg)
    jtree = {k: v for k, v in jtree.items() if k != "ints"}
    live = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
            for k, d in tree.items() if k != "ints"}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 5)).astype(np.float32))

    def loss_t(p):
        e = lora_effective(p, cfg)
        return ((x @ e["fc0"]["w"] + e["fc0"]["b"]) @ e["head"]["w"]).square().sum()

    def loss_j(p):
        e = jm.lora_effective(p, cfg)
        return jnp.sum(jnp.square((jnp.asarray(x.numpy()) @ e["fc0"]["w"] + e["fc0"]["b"])
                                  @ e["head"]["w"]))

    loss_t(live).backward()
    jg = jax.grad(loss_j)(jtree)
    for k in ("fc0", "head"):
        for n in ("w.lora_a", "w.lora_b", "w"):
            np.testing.assert_allclose(live[k][n].grad.numpy(), np.asarray(jg[k][n]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt_name,lr", [("sgdm", 1e-2), ("adamw", 1e-2)])
def test_masked_optimizer_matches_reference_on_same_gradients(opt_name, lr):
    """Three steps on the same numpy gradients: trainable leaves within
    1e-6 of the reference's, frozen leaves returned verbatim (AdamW would
    weight-decay them otherwise)."""
    cfg = LoRAConfig(rank=2, alpha=4.0, targets=("w",))
    jtree, tree = _injected(cfg)
    jtree, tree = ({k: d for k, d in t.items() if k != "ints"} for t in (jtree, tree))
    opt, jopt = masked(make_optimizer(opt_name, lr), ".lora_"), \
        jax_masked(jax_make_optimizer(opt_name, lr), ".lora_")
    state, jstate = opt.init(tree), jopt.init(jtree)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
                            jax.tree.map(np.asarray, jtree))
        new, state = opt.update(params_from_numpy(g_np, device="cpu"), state, tree)
        jnew, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate, jtree)
        _close(new, jnew)
        for k in tree:
            for n, v in tree[k].items():
                if ".lora_" not in n:
                    assert new[k][n] is v
        tree, jtree = new, jnew
    # the state holds only the trainable leaves
    n_trainable = sum(".lora_" in keystr(p) for p, _ in tree_flatten_with_path(tree)[0])
    inner = state.m if opt_name == "adamw" else state.momentum
    assert len(tree_flatten(inner)[0]) == n_trainable


def test_masked_optimizer_takes_none_for_frozen_gradients_and_callables():
    tree = {"a": torch.ones(2), "a.lora_b": torch.ones(2)}
    opt = MaskedOptimizer(make_optimizer("sgdm", 0.5), lambda p: p.endswith("lora_b']"))
    assert tree_flatten(opt.trainable_mask(tree))[0] == [False, True]
    new, _ = opt.update({"a": None, "a.lora_b": torch.ones(2)}, opt.init(tree), tree)
    assert new["a"] is tree["a"] and torch.equal(new["a.lora_b"], torch.full((2,), 0.5))
    with pytest.raises(ValueError, match="gradients for"):
        opt.update({"a.lora_b": torch.ones(2)}, opt.init(tree), tree)


def test_client_under_a_masked_optimizer_trains_only_the_adapters():
    """The port's FLClient differentiates only the leaves a masked
    optimizer trains; its result is the reference client's (which
    differentiates every leaf) on the same data and weights: frozen
    leaves verbatim, adapters within 1e-5."""
    from repro.data import make_lm_silos as jax_lm_silos
    from repro.federated import FLClient as JaxClient
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import FLClient

    cfg = LoRAConfig(rank=2, alpha=4.0, targets=("w",))
    rng = np.random.default_rng(7)
    V, S, D = 16, 8, 6
    base = {"emb": rng.standard_normal((V, D)).astype(np.float32) * 0.3,
            "fc": {"w": rng.standard_normal((D, D)).astype(np.float32) * 0.3},
            "head": {"w": rng.standard_normal((D, V)).astype(np.float32) * 0.3}}
    jtree = jm.inject_lora(jax.tree.map(jnp.asarray, base), jax.random.PRNGKey(2), cfg)
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")

    def jloss(p, b):
        e = jm.lora_effective(p, cfg)
        h = jnp.tanh(e["emb"][b[0]] @ e["fc"]["w"]) @ e["head"]["w"]
        logp = jax.nn.log_softmax(h, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, b[1][..., None], axis=-1))

    def tloss(p, b):
        e = lora_effective(p, cfg)
        h = torch.tanh(e["emb"][b[0].long()] @ e["fc"]["w"]) @ e["head"]["w"]
        return torch.nn.functional.cross_entropy(h.reshape(-1, V), b[1].long().reshape(-1))

    samples = [(4, 2)]
    jc = JaxClient("c0", jax_lm_silos(1, V, S, samples, seed=0)[0], jloss,
                   jax_masked(jax_make_optimizer("adamw", 1e-2), ".lora_"), batch_size=2,
                   batch_fn=lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
    tc = FLClient("c0", make_lm_silos(1, V, S, samples, seed=0)[0], tloss,
                  masked(make_optimizer("adamw", 1e-2), ".lora_"), batch_size=2, device="cpu")
    calls = []
    orig = torch.autograd.grad

    def spy(outputs, inputs, *a, **k):
        calls.append(len(inputs))
        return orig(outputs, inputs, *a, **k)

    torch.autograd.grad = spy
    try:
        got = tc.train(tree)
    finally:
        torch.autograd.grad = orig
    want = jc.train(jtree)
    assert calls == [4, 4]  # two steps, four factor leaves each
    assert got.n_samples == want.n_samples
    _close(got.params, want.params, tol=1e-5)
    for k in ("emb",):
        assert got.params[k] is tree[k]
    assert got.params["fc"]["w"] is tree["fc"]["w"]


def test_convert_carries_injected_lora_trees_by_path():
    """fp32 factors beside bf16 bases: numpy -> port -> numpy, bit for bit
    and dtype for dtype, in the reference's key order."""
    cfg = LoRAConfig(rank=2, alpha=4.0, targets=("wq", "wv"))
    rng = np.random.default_rng(8)
    base = {"layers": {"attn": {n: jnp.asarray(rng.standard_normal((2, 8, 8)), jnp.bfloat16)
                                for n in ("wq", "wk", "wv", "wo")}},
            "embed": {"tok": jnp.asarray(rng.standard_normal((10, 8)), jnp.bfloat16)}}
    jtree = jm.inject_lora(base, jax.random.PRNGKey(3), cfg)
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    attn = tree["layers"]["attn"]
    assert attn["wq"].dtype == torch.bfloat16 and attn["wq.lora_a"].dtype == torch.float32
    assert "wk.lora_a" not in attn
    back = params_to_numpy(tree)
    for (p, a), (jp, b) in zip(tree_flatten_with_path(back)[0],
                               jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert keystr(p) == jax.tree_util.keystr(jp)
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# One federated LoRA round of reduced olmo-1b in both packages
# ---------------------------------------------------------------------------

LORA_SAMPLES = [(4, 2), (4, 2)]
LORA_SEQ = 16
_TIME_FIELDS = {"time_s", "span_s", "overhead_s"}


def _wall_free_trace(bus):
    import dataclasses

    out = []
    for e in bus.trace:
        d = dataclasses.asdict(e)
        if type(e).__name__ in ("RoundDispatched", "CheckpointSaved", "RecoveryCompleted"):
            d = {k: v for k, v in d.items() if k not in _TIME_FIELDS}
        out.append((type(e).__name__, d))
    return out


def _lora_round_jax(codec):
    from repro.configs import get_config as jax_config
    from repro.data import make_lm_silos as jax_lm_silos
    from repro.federated import FLClient as JaxClient
    from repro.federated import async_server as ja
    from repro.launch.steps import make_optimizer_for as jax_optimizer_for
    from repro.models import get_model as jax_model

    cfg = jax_config("olmo-1b").reduced().with_overrides(
        dtype="float32", param_dtype="float32").with_lora(2)
    lcfg = jm.LoRAConfig(rank=cfg.lora_rank, alpha=cfg.lora_alpha, targets=cfg.lora_targets)
    model = jax_model(cfg)
    params = jm.inject_lora(model.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1), lcfg)

    def loss_fn(p, b):
        return model.loss(jm.lora_effective(p, lcfg), {"tokens": b[0], "labels": b[1]})

    opt = jax_masked(jax_optimizer_for(cfg), ".lora_")
    clients = [JaxClient(s.client_id, s, loss_fn, opt, batch_size=2,
                         batch_fn=lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
               for s in jax_lm_silos(2, cfg.vocab_size, LORA_SEQ, LORA_SAMPLES, seed=0)]
    server = ja.AsyncFLServer(clients, params, schema=jm.lora_adapter_schema(),
                              compression=codec, fold_cost_s=0.01, measure_round_messages=True)
    return params, server, server.run(1)


def _lora_round_port(codec, params0):
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import FLClient
    from repro_torch.federated import async_server as ta
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models import get_model

    cfg = get_config("olmo-1b").reduced().with_overrides(
        dtype="float32", param_dtype="float32").with_lora(2)
    lcfg = LoRAConfig(rank=cfg.lora_rank, alpha=cfg.lora_alpha, targets=cfg.lora_targets)
    model = get_model(cfg)

    def loss_fn(p, b):
        return model.loss(lora_effective(p, lcfg), {"tokens": b[0], "labels": b[1]})

    opt = masked(make_optimizer_for(cfg), ".lora_")
    clients = [FLClient(s.client_id, s, loss_fn, opt, batch_size=2, device="cpu")
               for s in make_lm_silos(2, cfg.vocab_size, LORA_SEQ, LORA_SAMPLES, seed=0)]
    params = params_from_numpy(jax.tree.map(np.asarray, params0), device="cpu")
    server = ta.AsyncFLServer(clients, params, schema=lora_adapter_schema(), compression=codec,
                              fold_cost_s=0.01, measure_round_messages=True, device="cpu")
    return params, server, server.run(1)


@pytest.fixture(scope="module", params=[None, "int8"])
def lora_rounds(request):
    jp0, jserver, jrun = _lora_round_jax(request.param)
    tp0, tserver, trun = _lora_round_port(request.param, jp0)
    return request.param, jp0, jserver, jrun, tp0, tserver, trun


def test_lora_round_adapters_match_and_base_is_untouched(lora_rounds):
    codec, jp0, _, jrun, tp0, _, trun = lora_rounds
    got, want = trun.final_params, jrun.final_params
    n_adapters = 0
    for (path, t), (_, j), t0 in zip(tree_flatten_with_path(got)[0],
                                     jax.tree_util.tree_flatten_with_path(want)[0],
                                     tree_flatten(tp0)[0]):
        if ".lora_" in keystr(path):
            n_adapters += 1
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5,
                                       err_msg=keystr(path))
        else:
            assert torch.equal(t, t0), keystr(path)           # the base, bit for bit
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert n_adapters == 8  # wq, wk, wv, wo x (a, b)
    moved = [not torch.equal(t, t0) for (p, t), t0 in zip(tree_flatten_with_path(got)[0],
                                                          tree_flatten(tp0)[0])
             if keystr(p).endswith(".lora_b']")]
    assert all(moved)
    assert abs(trun.rounds[0].metrics["loss"] - jrun.rounds[0].metrics["loss"]) < 1e-5


def test_lora_round_traces_and_group_bytes_equal(lora_rounds):
    import dataclasses

    codec, _, jserver, jrun, _, tserver, trun = lora_rounds
    assert _wall_free_trace(tserver.bus) == _wall_free_trace(jserver.bus)
    tlog, jlog = trun.rounds[0].message_log, jrun.rounds[0].message_log
    assert dataclasses.asdict(tlog) == dataclasses.asdict(jlog)
    assert tlog.codec == ("structured" if codec is None else "structured:int8")
    assert set(tlog.group_wire_bytes) == {"adapters"}
    assert tlog.compression_ratio > 50
    assert tserver.agg_engine.stats.total_wire_bytes == jserver.agg_engine.stats.total_wire_bytes
    assert tserver.agg_engine.stats.total_folded_bytes == \
        jserver.agg_engine.stats.total_folded_bytes
