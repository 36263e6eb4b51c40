"""The port's AggregationEngine against the reference's, on the shared
fixtures (conftest.ragged_trees, conftest.make_results).  The reference
runs its Pallas path in interpret mode (use_pallas=True, interpret=True):
the same flatten-once layout and the same kernel arithmetic the port
runs.  Tolerances are the kernel's: 2e-5 for fp32, 2e-2 for bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_results, ragged_trees
from repro.federated.agg_engine import AggregationEngine as JaxEngine
from repro.federated.agg_engine import plan_for as jax_plan_for
from repro_torch.convert import params_from_numpy
from repro_torch.federated.agg_engine import (
    AggregationEngine,
    StructureMismatchError,
    clear_plan_cache,
    plan_cache_size,
    plan_for,
    set_plan_cache_limit,
)
from repro_torch.kernels.fedavg_reduce import BLOCK, fedavg_reduce
from repro_torch.utils.tree import path_str, tree_flatten_with_path


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-5


def _assert_same_tree(got, want, dtype):
    pairs, _ = tree_flatten_with_path(got)
    jpairs = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(pairs) == len(jpairs)
    for (path, t), (_, j) in zip(pairs, jpairs):
        assert tuple(t.shape) == j.shape, path_str(path)
        assert str(t.dtype)[6:] == j.dtype.name, path_str(path)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype), err_msg=path_str(path))


def _jax_engine(**kw):
    return JaxEngine(use_pallas=True, interpret=True, **kw)


@pytest.mark.parametrize("n_clients", [2, 3, 5])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_aggregate_ragged_trees(n_clients, dtype):
    trees, weights = ragged_trees(n_clients, dtype=dtype, seed=n_clients)
    want = _jax_engine().aggregate(trees, weights)
    engine = AggregationEngine()
    got = engine.aggregate([_port(t) for t in trees], weights)
    _assert_same_tree(got, want, dtype)
    assert engine.stats.n_calls == 1


@pytest.mark.parametrize("n_clients", [1, 4])
def test_aggregate_make_results(n_clients):
    results = make_results(n_clients, shapes=((3, 5), (7,), (2, 2, 2)), seed=11)
    trees = [r.params for r in results]
    weights = [r.n_samples for r in results]
    jeng = _jax_engine()
    want = jeng.aggregate(trees, weights)
    engine = AggregationEngine()
    got = engine.aggregate([_port(t) for t in trees], weights)
    _assert_same_tree(got, want, jnp.float32)
    assert engine.stats.last_bytes == jeng.stats.last_bytes
    assert engine.stats.total_wire_bytes == jeng.stats.total_wire_bytes


@pytest.mark.parametrize("chunk", [None, 100, 4096, BLOCK])
@pytest.mark.parametrize("length", [300, 20000])
def test_reduce_flat_plain_and_chunked(chunk, length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((4, length)).astype(np.float32)
    w = rng.uniform(0.5, 5.0, 4).astype(np.float32)
    want = _jax_engine().reduce_flat(jnp.asarray(x), jnp.asarray(w), chunk_elems=chunk)
    got = AggregationEngine().reduce_flat(torch.from_numpy(x), torch.from_numpy(w),
                                          chunk_elems=chunk)
    assert got.shape == (length,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_engine_chunk_setting_matches_unchunked():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 10000)).astype(np.float32))
    w = [1.0, 2.0, 3.0]
    a = AggregationEngine(chunk_elems=999).reduce_flat(x, w)
    b = AggregationEngine().reduce_flat(x, w)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_plan_layout_and_signature_match_reference():
    trees, _ = ragged_trees(2, seed=3)
    jplan = jax_plan_for(trees[0])
    plan = plan_for(_port(trees[0]))
    assert plan.signature == jplan.signature
    assert plan.shapes == jplan.shapes and plan.sizes == jplan.sizes
    assert plan.total_elems == jplan.total_elems
    assert plan.row_stride % BLOCK == 0 and plan.row_stride >= plan.total_elems
    stacked = plan.flatten_stack([_port(t) for t in trees])
    want = np.asarray(jplan.flatten_stack(trees))
    assert stacked.shape == want.shape and stacked.stride() == (plan.row_stride, 1)
    np.testing.assert_array_equal(stacked.numpy(), want)
    np.testing.assert_array_equal(plan.flatten(_port(trees[1])).numpy(),
                                  np.asarray(jplan.flatten(trees[1])))


def test_structure_mismatch_is_typed():
    a = {"w": torch.ones(3), "b": torch.ones(2)}
    engine = AggregationEngine()
    with pytest.raises(StructureMismatchError) as info:
        engine.aggregate([a, {"w": torch.ones(4), "b": torch.ones(2)}], [1, 1])
    assert info.value.path == "w"
    with pytest.raises(StructureMismatchError):
        engine.aggregate([a, {"w": torch.ones(3)}], [1, 1])


@pytest.mark.parametrize("weights", [[], [0.0, 0.0], [[1.0, 2.0]]])
def test_bad_weights_raise(weights):
    with pytest.raises(ValueError):
        AggregationEngine().aggregate([{"w": torch.ones(2)}] * 2, weights)


def test_plan_cache_is_bounded_lru():
    clear_plan_cache()
    old = set_plan_cache_limit(64)
    try:
        trees = [{"w": torch.ones(i + 1)} for i in range(5)]
        plans = [plan_for(t) for t in trees]
        assert plan_cache_size() == 5
        assert plan_for(trees[0]) is plans[0]
        set_plan_cache_limit(2)
        assert plan_cache_size() == 2
        assert plan_for(trees[4]) is plans[4]
        with pytest.raises(ValueError):
            set_plan_cache_limit(0)
    finally:
        set_plan_cache_limit(old)
        clear_plan_cache()


def test_cpu_aggregate_launches_no_kernel():
    trees, weights = ragged_trees(3, seed=9)
    before = fedavg_reduce.launches
    AggregationEngine().aggregate([_port(t) for t in trees], weights)
    assert fedavg_reduce.launches == before


# ---------------------------------------------------------------------------
# The stacked reduces (tests/test_agg_engine.py:328, tests/test_federated.py:70)
# ---------------------------------------------------------------------------

def _stack(rng, n, dtype):
    return {"w": jnp.asarray(rng.standard_normal((n, 6, 5)), dtype),
            "b": jnp.asarray(rng.standard_normal((n, 13)), dtype),
            "scalarish": jnp.asarray(rng.standard_normal((n,)), dtype)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fedavg_stacked_fused_matches_per_leaf(dtype):
    """``fedavg_stacked`` (one fused (N, L) reduce) against the reference's
    on the same stack, and against the per-leaf formula."""
    from repro.federated.aggregation import fedavg_stacked as jax_fedavg_stacked
    from repro_torch.federated.aggregation import fedavg_stacked

    rng = np.random.default_rng(3)
    stacked = _stack(rng, 4, dtype)
    weights = rng.uniform(0.5, 3.0, 4).astype(np.float32)
    got = fedavg_stacked(_port(stacked), torch.from_numpy(weights))
    _assert_same_tree(got, jax_fedavg_stacked(stacked, jnp.asarray(weights)), dtype)
    wn = weights / weights.sum()
    want = {k: jnp.asarray(np.tensordot(wn, np.asarray(v, np.float32), axes=1), dtype)
            for k, v in stacked.items()}
    _assert_same_tree(got, want, dtype)
    assert got["scalarish"].shape == ()


@pytest.mark.parametrize("n,shapes,seed", [
    (2, ((3,), (2, 2)), 0),
    (3, ((5, 4), (7,)), 1),
    (5, ((1,), (9, 3)), 2),
    (8, ((2, 3, 4), (6,)), 3),
])
def test_fedavg_stacked_matches_list(n, shapes, seed):
    """Deterministic twins of the reference's hypothesis property: the
    stacked reduce of N trees equals ``fedavg`` of the list (1e-5), in the
    port and in the reference."""
    from repro.federated.aggregation import fedavg as jax_fedavg
    from repro.federated.aggregation import fedavg_stacked as jax_fedavg_stacked
    from repro_torch.federated.aggregation import fedavg, fedavg_stacked

    rng = np.random.default_rng(seed)
    trees = [{"w": rng.standard_normal(shapes[0]).astype(np.float32),
              "b": rng.standard_normal(shapes[1]).astype(np.float32)} for _ in range(n)]
    weights = [float(w) for w in rng.uniform(1.0, 50.0, n)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in ("w", "b")}
    got = fedavg_stacked({k: torch.from_numpy(v) for k, v in stacked.items()},
                         torch.tensor(weights))
    want = fedavg([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees], weights)
    jgot = jax_fedavg_stacked({k: jnp.asarray(v) for k, v in stacked.items()},
                              jnp.asarray(weights, jnp.float32))
    jwant = jax_fedavg([{k: jnp.asarray(v) for k, v in t.items()} for t in trees], weights)
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jgot[key]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jgot[key]), np.asarray(jwant[key]),
                                   rtol=1e-5, atol=1e-5)


def test_stacked_reduce_uses_the_padded_layout(monkeypatch):
    """The (N, L) buffer handed to ``fedavg_reduce`` is a view of an
    (N, Lp) buffer, Lp a multiple of BLOCK, also when L % 4 == 2 (the
    paper's FEMNIST width): every row starts 16-byte aligned.  An empty
    tree comes back as it is."""
    from repro_torch.federated import agg_engine

    seen = []

    def spy(stacked, weights):
        seen.append((tuple(stacked.shape), stacked.stride(), weights.dtype))
        return fedavg_reduce(stacked, weights)

    monkeypatch.setattr(agg_engine, "fedavg_reduce", spy)
    stacked = {"a": torch.randn(3, 5, 2), "b": torch.randn(3, 4)}  # L = 14, L % 4 == 2
    out = agg_engine.fused_stacked_tree_reduce(stacked, [1.0, 2.0, 3.0])
    assert seen == [((3, 14), (BLOCK, 1), torch.float32)]
    assert out["a"].shape == (5, 2) and out["b"].shape == (4,)
    assert agg_engine.fused_stacked_tree_reduce({}, [1.0]) == {}


def test_stacked_reduce_returns_each_leaf_in_its_dtype():
    from repro_torch.federated.agg_engine import fused_stacked_tree_reduce

    stacked = {"h": torch.randn(2, 3).to(torch.bfloat16), "f": torch.randn(2, 4)}
    out = fused_stacked_tree_reduce(stacked, torch.tensor([1.0, 3.0]))
    assert out["h"].dtype == torch.bfloat16 and out["f"].dtype == torch.float32
    np.testing.assert_allclose(out["f"].numpy(), (stacked["f"][0] * 0.25 + stacked["f"][1] * 0.75)
                               .numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_stacked_reduce_launches_the_kernel_on_card():
    """On the card: one ``fedavg_reduce`` launch, within 2e-5 of the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.federated.agg_engine import fused_stacked_tree_reduce

    stacked = {"a": torch.randn(4, 300, 7), "b": torch.randn(4, 1001)}
    w = torch.tensor([1.0, 2.0, 3.0, 4.0])
    before = fedavg_reduce.launches
    got = fused_stacked_tree_reduce({k: v.cuda() for k, v in stacked.items()}, w.cuda())
    assert fedavg_reduce.launches == before + 1
    want = fused_stacked_tree_reduce(stacked, w)
    for k in stacked:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), atol=2e-5, rtol=2e-5)
