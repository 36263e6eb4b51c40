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
    assert engine.stats.n_calls == 1 and engine.stats.n_traces == 0


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
