"""The port's two-level aggregation hierarchy against the reference's.

Mirrors tests/test_hierarchy.py, its three ``test_experiment_hierarchy_*``
tests on the port's ``Experiment``.  Both packages get the same numpy-seeded dyadic
trees (integers in [-128, 128) times 2^-6, integer weights 1-15: no sum
of them rounds in fp32, nor in fp16 on the wire), so inside the port the
hierarchical fold must be bit-equal to the flat one, as the reference
pins it inside its own package; across packages params agree within the
reference's 1e-6.  Event traces, client counts, weight totals, wire
bytes and exception types must be equal; where a scenario compares
traces the fold cost is fixed (``fold_cost_s``), so the virtual clock is
pure arithmetic.

The reference's hypothesis property runs here as eight scenarios drawn
from a seeded numpy generator.  ``ShardedPartialFolder`` runs as a pod of
one process, on a gloo group of one process (default group and a "pod"
``DeviceMesh``) and, spawned, on two gloo ranks; the NCCL route is a
``gpu`` test.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import StubClient
from repro.core.control_plane import HierarchyAPI as JaxHierarchyAPI
from repro.core.events import EventBus as JaxBus
from repro.federated import agg_engine as jagg
from repro.federated import async_server as ja
from repro.federated import hierarchy as jh
from repro.federated.client import ClientResult as JaxResult
from repro.federated.compression import CompressionSpec as JaxSpec
from repro.federated.compression import compress as jax_compress
from repro_torch.core import Experiment
from repro_torch.core.control_plane import HierarchyAPI
from repro_torch.core.events import EventBus, PartialFolded, RegionClosed
from repro_torch.federated import async_server as ta
from repro_torch.federated import hierarchy as th
from repro_torch.federated.agg_engine import AggregationEngine, StructureMismatchError, plan_for
from repro_torch.federated.client import ClientResult, EvalResult
from repro_torch.federated.compression import CompressionSpec, compress
from repro_torch.utils.tree import tree_flatten

from _torch_pod_worker import pod_rank

SHAPES = ((4, 3), (5,))


# ---------------------------------------------------------------------------
# exact-arithmetic fixtures, one numpy stream for both packages
# ---------------------------------------------------------------------------

def _np_dyadic(rng, shapes=SHAPES):
    return {f"leaf{i}": rng.integers(-128, 128, size=s).astype(np.float32) * 2.0**-6
            for i, s in enumerate(shapes)}


def _pair(tree):
    """(port tree, reference tree) of one numpy tree."""
    return ({k: torch.from_numpy(v.copy()) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def dyadic_results(n, seed=0, shapes=SHAPES):
    """(port results, reference results): the reference test's draws."""
    rng = np.random.default_rng(seed)
    tres, jres = [], []
    for i in range(n):
        t, j = _pair(_np_dyadic(rng, shapes))
        w = int(rng.integers(1, 16))
        tres.append(ClientResult(f"c{i}", t, w, 0.0))
        jres.append(JaxResult(f"c{i}", j, w, 0.0))
    return tres, jres


def dyadic_base(seed, shapes=SHAPES):
    return _pair(_np_dyadic(np.random.default_rng(seed), shapes))


def compress_results(tres, jres, tbase, jbase, codec, base_round=0):
    """Each result's params as a CompressedUpdate delta, in both packages."""
    tplan, jplan = plan_for(tbase), jagg.plan_for(jbase)
    tb, jb = tplan.flatten(tbase), np.asarray(jplan.flatten(jbase), np.float32)
    tout = [ClientResult(r.client_id, compress(tplan.flatten(r.params) - tb, CompressionSpec(codec),
                                               base_round=base_round), r.n_samples, 0.0)
            for r in tres]
    jout = [JaxResult(r.client_id, jax_compress(np.asarray(jplan.flatten(r.params), np.float32) - jb,
                                                JaxSpec(codec), base_round=base_round),
                      r.n_samples, 0.0)
            for r in jres]
    return tout, jout


def flat_fold(results, base, base_round=0):
    """The port's single-engine oracle: one flat/delta streaming fold."""
    agg = AggregationEngine().streaming(base=base, base_round=base_round)
    for r in results:
        agg.add(r.params, r.n_samples)
    return agg.result()


def region_map_from(assign, client_ids):
    mapping = {}
    for cid, j in zip(client_ids, assign):
        mapping.setdefault(f"r{j}", []).append(cid)
    return mapping


def assert_bit_equal(got, want):
    a, b = tree_flatten(got)[0], tree_flatten(want)[0]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), f"max diff {(x - y).abs().max()}"
        assert torch.equal(torch.signbit(x), torch.signbit(y))


def assert_close_to_jax(got, want, atol=1e-6):
    a, b = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == y.shape and str(x.dtype)[6:] == y.dtype.name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=atol, rtol=atol)


def _trace(bus):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in bus.trace]


_REPORT_FIELDS = ("excluded", "rerequested", "fold_times", "round_span_s", "busy_s",
                  "idle_s", "barrier_span_s", "deadline_s", "carried_over", "carried_in",
                  "escalations")


def assert_reports_equal(got, want):
    """Two FoldReports (fold cost fixed): every field but the params.  A
    hierarchy's report adds its parent fold's measured wall time to its
    span, busy and barrier times; those are compared without it."""
    assert [dataclasses.asdict(e) for e in got.events] == \
        [dataclasses.asdict(e) for e in want.events]
    parent = getattr(got, "parent_fold_s", None)
    for f in _REPORT_FIELDS:
        if parent is not None and f in ("round_span_s", "busy_s", "idle_s", "barrier_span_s"):
            if f != "idle_s":
                assert getattr(got, f) - parent == pytest.approx(
                    getattr(want, f) - want.parent_fold_s, abs=1e-9), f
            continue
        assert getattr(got, f) == getattr(want, f), f


def assert_partials_equal(tparts, jparts):
    """Region ids, counts, weights, bases and wire bytes equal; the
    accumulators within 1e-6."""
    assert [(p.region_id, p.n_clients, p.wsum, p.base_round, p.plan_signature, p.wire_bytes)
            for p in tparts] == \
        [(p.region_id, p.n_clients, p.wsum, p.base_round, p.plan_signature, p.wire_bytes)
         for p in jparts]
    for t, j in zip(tparts, jparts):
        np.testing.assert_allclose(t.acc.numpy(), np.asarray(j.acc), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the partition property: hierarchy == flat, bit-for-bit
# ---------------------------------------------------------------------------

def _check_partition_equivalence(n, assign, seed, codec, sharded):
    tres, jres = dyadic_results(n, seed=seed)
    tbase, jbase = dyadic_base(seed + 1)
    if codec is not None:
        tres, jres = compress_results(tres, jres, tbase, jbase, codec)
    want = flat_fold(tres, tbase)
    rmap = region_map_from(assign, [r.client_id for r in tres])
    coord = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), sharded=sharded)
    report = coord.fold_round(0, tres, ta.InstantSchedule(), base_params=tbase)
    assert_bit_equal(report.params, want)
    # weight conservation: the partials carry every client exactly once
    assert sum(p.n_clients for p in report.partials) == n
    assert sum(p.wsum for p in report.partials) == sum(r.n_samples for r in tres)
    jcoord = jh.HierarchyCoordinator(rmap, agg_engine=jagg.AggregationEngine(), sharded=sharded)
    jrep = jcoord.fold_round(0, jres, ja.InstantSchedule(), base_params=jbase)
    assert_close_to_jax(report.params, jrep.params)
    assert_partials_equal(report.partials, jrep.partials)


def _drawn_scenario(i):
    """The reference's hypothesis draw, from a seeded numpy generator."""
    rng = np.random.default_rng(1000 + i)
    n = int(rng.integers(2, 13))
    n_regions = int(rng.integers(1, n + 1))
    assign = [int(a) for a in rng.integers(0, n_regions, size=n)]
    return n, assign, int(rng.integers(0, 2**16)), [None, "fp16"][i % 2], bool(i // 2 % 2)


@pytest.mark.parametrize("i", range(8))
def test_any_partition_matches_flat_fold(i):
    """For drawn partitions of N clients into regions, regional folds +
    fold_partial == the flat single-engine fold, bit for bit (dense and
    fp16-compressed, sharded and sequential)."""
    _check_partition_equivalence(*_drawn_scenario(i))


@pytest.mark.parametrize("codec", [None, "fp16"])
@pytest.mark.parametrize(
    "assign",
    [[0] * 6, [0, 1, 2, 3, 4, 5], [0, 0, 1, 1, 2, 2], [2, 0, 1, 0, 2, 1]],
)
def test_partition_matches_flat_fold_deterministic(assign, codec):
    _check_partition_equivalence(6, assign, seed=7, codec=codec, sharded=False)


def test_int8_partition_matches_flat_fold_exactly():
    """The same int8 updates through a 3-region split: within 1e-6 of the
    flat fold of those updates (the reference's bound), and of the
    reference's hierarchy on the byte-equal frames."""
    tres, jres = dyadic_results(8, seed=3)
    tbase, jbase = dyadic_base(99)
    tres, jres = compress_results(tres, jres, tbase, jbase, "int8")
    want = flat_fold(tres, tbase)
    rmap = th.partition_regions([r.client_id for r in tres], 3)
    report = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine()).fold_round(
        0, tres, ta.InstantSchedule(), base_params=tbase)
    for a, b in zip(tree_flatten(report.params)[0], tree_flatten(want)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    jrep = jh.HierarchyCoordinator(rmap, agg_engine=jagg.AggregationEngine()).fold_round(
        0, jres, ja.InstantSchedule(), base_params=jbase)
    assert_close_to_jax(report.params, jrep.params)
    assert_partials_equal(report.partials, jrep.partials)


def test_sharded_fold_matches_sequential():
    tres, _ = dyadic_results(9, seed=5)
    tbase, _ = dyadic_base(6)
    rmap = th.partition_regions([r.client_id for r in tres], 4)
    seq = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine())
    shd = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), sharded=True)
    r_seq = seq.fold_round(0, tres, ta.InstantSchedule(), base_params=tbase)
    r_shd = shd.fold_round(0, tres, ta.InstantSchedule(), base_params=tbase)
    assert_bit_equal(r_shd.params, r_seq.params)
    assert shd.folder.pod_size == 1 and shd.folder.n_collectives == 0  # a pod of one
    assert seq.folder is None


def test_sharded_folder_pads_to_pod_multiple():
    folder = th.ShardedPartialFolder()
    accs = [np.full(16, float(i + 1), np.float32) for i in range(3)]
    got = folder.reduce(accs)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.full(16, 6.0, np.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jh.ShardedPartialFolder().reduce(accs)))
    assert folder.pod_size == 1 and folder.n_collectives == 0


# ---------------------------------------------------------------------------
# the pod on torch.distributed
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_pod(tmp_path):
    """A gloo process group of one process, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_gloo_pod_of_one_all_reduces(gloo_pod):
    """The default group and a 1-D "pod" DeviceMesh over it: the stack
    is summed and all-reduced, once a reduce; a sharded coordinator on
    the group folds bit-equal to the sequential parent."""
    from torch.distributed.device_mesh import DeviceMesh

    accs = [torch.full((16,), float(i + 1)) for i in range(3)]
    for folder in (th.ShardedPartialFolder(),
                   th.ShardedPartialFolder(DeviceMesh("cpu", [0], mesh_dim_names=("pod",)))):
        assert folder.pod_size == 1
        np.testing.assert_array_equal(folder.reduce(accs).numpy(), np.full(16, 6.0, np.float32))
        assert folder.n_collectives == 1
    tres, _ = dyadic_results(7, seed=8)
    tbase, _ = dyadic_base(9)
    rmap = th.partition_regions([r.client_id for r in tres], 3)
    shd = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), sharded=True)
    got = shd.fold_round(0, tres, ta.InstantSchedule(), base_params=tbase)
    assert shd.folder.n_collectives == 1
    assert_bit_equal(got.params, flat_fold(tres, tbase))


def test_gloo_pod_refuses_other_devices(gloo_pod):
    """A gloo group all-reduces CPU tensors only: anything else raises
    before any collective runs."""
    folder = th.ShardedPartialFolder()
    with pytest.raises(ValueError, match="cannot all-reduce meta"):
        folder.reduce([torch.zeros(8, device="meta"), torch.zeros(8, device="meta")])
    assert folder.n_collectives == 0


def test_pod_mesh_must_be_one_dimension_named_pod(gloo_pod):
    from torch.distributed.device_mesh import DeviceMesh

    with pytest.raises(ValueError, match="named \\('pod',\\)"):
        th.ShardedPartialFolder(DeviceMesh("cpu", [0], mesh_dim_names=("dp",)))


@pytest.mark.parametrize("backend,device,ok", [
    ("gloo", "cpu", True),
    ("nccl", "cuda", True),
    ("cpu:gloo,cuda:nccl", "cuda", True),
    ("cpu:gloo,cuda:nccl", "cpu", True),
    ("nccl", "cpu", False),
    ("gloo", "cuda", False),
    ("cpu:gloo", "cuda", False),
    ("gloo", "meta", False),
])
def test_backend_must_match_the_accumulators_device(backend, device, ok):
    if ok:
        th._require_backend(backend, torch.device(device))
    else:
        with pytest.raises(ValueError, match="cannot all-reduce"):
            th._require_backend(backend, torch.device(device))


def test_two_rank_gloo_pod_splits_rows_and_all_reduces(tmp_path):
    """Two spawned gloo ranks (60 s limit of their own, against ~5 s of
    work): 3 replicated rows are padded to 4 and each rank sums 2; with
    rows that differ by rank, the total shows that rank 0 summed rows 0-1
    of its stack and rank 1 rows 2-3 of its own."""
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [mp.get_context("spawn").Process(target=pod_rank,
                                             args=(r, 2, str(tmp_path / "pg"), outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 60.0
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        assert not any(p.is_alive() for p in procs), "the pod did not finish in 60 s"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for r, out in enumerate(outs):
        got = torch.load(out)
        assert got["pod_size"] == 2 and got["n_collectives"] == 2, r
        np.testing.assert_array_equal(got["same"].numpy(), np.full(16, 6.0, np.float32))
        np.testing.assert_array_equal(got["tagged"].numpy(),
                                      np.full(16, (1 + 10) * 1 + (100 + 1000) * 2, np.float32))


@pytest.mark.gpu
def test_nccl_pod_of_one_on_card(tmp_path):
    """On the card: an NCCL group of one process all-reduces CUDA
    accumulators, and the sharded hierarchy folds bit-equal to the flat
    fold; a gloo group refuses CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        tres, _ = dyadic_results(6, seed=4)
        tbase, _ = dyadic_base(5)
        cres = [dataclasses.replace(r, params={k: v.cuda() for k, v in r.params.items()})
                for r in tres]
        cbase = {k: v.cuda() for k, v in tbase.items()}
        shd = th.HierarchyCoordinator(th.partition_regions([r.client_id for r in cres], 3),
                                      agg_engine=AggregationEngine(), sharded=True)
        got = shd.fold_round(0, cres, ta.InstantSchedule(), base_params=cbase)
        assert shd.folder.n_collectives == 1
        assert_bit_equal(got.params, flat_fold(cres, cbase))
        assert all(v.is_cuda for v in got.params.values())
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="cannot all-reduce cuda"):
        th._require_backend("gloo", torch.device("cuda"))


# ---------------------------------------------------------------------------
# partial-sum export/fold contract
# ---------------------------------------------------------------------------

def test_export_partial_consumes_state_and_composes():
    tres, jres = dyadic_results(4, seed=11)
    tbase, jbase = dyadic_base(12)
    want = flat_fold(tres, tbase)

    def parts(engine, res, base):
        agg_a = engine.streaming(base=base, base_round=0)
        agg_b = engine.streaming(base=base, base_round=0)
        for r in res[:2]:
            agg_a.add(r.params, r.n_samples)
        for r in res[2:]:
            agg_b.add(r.params, r.n_samples)
        pa, pb = agg_a.export_partial(region_id="a"), agg_b.export_partial(region_id="b")
        assert agg_a.n_clients == 0  # exported == consumed
        return pa, pb

    engine = AggregationEngine()
    pa, pb = parts(engine, tres, tbase)
    assert pa.region_id == "a" and pa.n_clients == 2
    assert pa.base_round == 0 and pa.wire_bytes == pa.acc.numel() * 4
    jengine = jagg.AggregationEngine()
    assert_partials_equal([pa, pb], parts(jengine, jres, jbase))

    parent = engine.streaming(base=tbase, base_round=0)
    parent.fold_partial(pa)
    parent.fold_partial(pb)
    assert_bit_equal(parent.result(), want)


def test_partial_fold_stats_match_reference():
    """AggStats of two exports and two partial folds: calls and bytes."""
    tres, jres = dyadic_results(4, seed=13)
    tbase, jbase = dyadic_base(14)
    stats = []
    for eng_cls, res, base in ((AggregationEngine, tres, tbase),
                               (jagg.AggregationEngine, jres, jbase)):
        engine = eng_cls()
        regs = []
        for ids in ((0, 1), (2, 3)):
            agg = engine.streaming(base=base, base_round=0)
            for i in ids:
                agg.add(res[i].params, res[i].n_samples)
            regs.append(agg.export_partial(region_id=str(ids)))
        parent = engine.streaming(base=base, base_round=0)
        for p in regs:
            parent.fold_partial(p, block=True)
        parent.result()
        s = engine.stats
        stats.append((s.n_calls, s.last_wire_bytes, s.total_wire_bytes, s.last_folded_bytes,
                      s.total_folded_bytes))
    assert stats[0] == stats[1]


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def test_export_partial_requires_flat_mode_and_clients():
    tbase, jbase = dyadic_base(0)
    for pkg_engine, base in ((AggregationEngine, tbase), (jagg.AggregationEngine, jbase)):
        with pytest.raises(ValueError, match="flat/delta"):
            pkg_engine().streaming().export_partial()
        with pytest.raises(ValueError, match="clients"):
            pkg_engine().streaming(base=base).export_partial()
    assert _raised(AggregationEngine().streaming().export_partial) == \
        _raised(jagg.AggregationEngine().streaming().export_partial)
    assert _raised(lambda: AggregationEngine().streaming().fold_partial(None)) == \
        _raised(lambda: jagg.AggregationEngine().streaming().fold_partial(None))


def test_fold_partial_rejects_structure_and_base_mismatch():
    """Same exception types and messages as the reference (the plan
    signatures are equal across packages)."""
    rng = np.random.default_rng(21)
    tbase, jbase = _pair(_np_dyadic(rng))
    extra_t, extra_j = _pair(_np_dyadic(rng))
    raised = []
    for eng_cls, base, extra, other_base, ones in (
            (AggregationEngine, tbase, extra_t, {"w": torch.zeros(7)}, {"w": torch.ones(7)}),
            (jagg.AggregationEngine, jbase, extra_j, {"w": jnp.zeros((7,), jnp.float32)},
             {"w": jnp.ones((7,), jnp.float32)})):
        engine = eng_cls()
        donor = engine.streaming(base=other_base, base_round=0)
        donor.add(ones, 2.0)
        alien = donor.export_partial(region_id="alien")
        parent = engine.streaming(base=base, base_round=0)
        with pytest.raises(StructureMismatchError if eng_cls is AggregationEngine
                           else jagg.StructureMismatchError, match="alien") as info:
            parent.fold_partial(alien)
        assert info.value.client_id == "alien"
        donor2 = engine.streaming(base=base, base_round=3)
        donor2.add(extra, 1.0)
        stale = donor2.export_partial(region_id="late")
        with pytest.raises(ValueError, match="base round"):
            parent.fold_partial(stale)
        empty = dataclasses.replace(stale, n_clients=0, base_round=0)
        negative = dataclasses.replace(stale, wsum=-1.0, base_round=0)
        short = dataclasses.replace(stale, acc=stale.acc[:8], base_round=0)
        raised.append([_raised(lambda a=alien: parent.fold_partial(a)),
                       _raised(lambda s=stale: parent.fold_partial(s)),
                       _raised(lambda e=empty: parent.fold_partial(e)),
                       _raised(lambda n=negative: parent.fold_partial(n)),
                       _raised(lambda s=short: parent.fold_partial(s))])
    assert raised[0] == raised[1]


def test_fold_partial_converts_dtype_and_device_explicitly():
    """A partial whose accumulator is fp64 or a numpy array folds as its
    fp32 value (the reference's jnp.asarray(acc, jnp.float32))."""
    tres, _ = dyadic_results(3, seed=15)
    tbase, _ = dyadic_base(16)
    agg = AggregationEngine().streaming(base=tbase, base_round=0)
    for r in tres:
        agg.add(r.params, r.n_samples)
    p = agg.export_partial(region_id="x")
    outs = []
    for acc in (p.acc, p.acc.double(), p.acc.numpy()):
        parent = AggregationEngine().streaming(base=tbase, base_round=0)
        parent.fold_partial(dataclasses.replace(p, acc=acc))
        outs.append(parent.result())
    for out in outs[1:]:
        assert_bit_equal(out, outs[0])


# ---------------------------------------------------------------------------
# cohort sampling
# ---------------------------------------------------------------------------

def test_cohort_sampler_deterministic_and_stable_order():
    ids = [f"c{i}" for i in range(20)]
    s = th.CohortSampler(fraction=0.3, seed=5)
    a = s.sample(4, ids)
    assert a == th.CohortSampler(fraction=0.3, seed=5).sample(4, ids)
    assert len(a) == 6
    assert a == [c for c in ids if c in set(a)]  # population order kept
    draws = {tuple(s.sample(r, ids)) for r in range(8)}
    assert len(draws) > 1
    js = jh.CohortSampler(fraction=0.3, seed=5)
    assert [s.sample(r, ids) for r in range(8)] == [js.sample(r, ids) for r in range(8)]


def test_cohort_sampler_size_and_bounds():
    ids = [f"c{i}" for i in range(5)]
    assert len(th.CohortSampler(size=3).sample(0, ids)) == 3
    assert th.CohortSampler(size=9).sample(0, ids) == ids  # clamped
    assert len(th.CohortSampler(fraction=0.01).sample(0, ids)) == 1  # floor
    for kw in ({"size": 3}, {"size": 9}, {"fraction": 0.01}, {"fraction": 0.5, "seed": 3}):
        assert [th.CohortSampler(**kw).sample(r, ids) for r in range(5)] == \
            [jh.CohortSampler(**kw).sample(r, ids) for r in range(5)]


@pytest.mark.parametrize("kw", [{}, {"fraction": 0.5, "size": 2}, {"fraction": 1.5},
                                {"fraction": 0.0}, {"size": 0}])
def test_cohort_sampler_validation(kw):
    with pytest.raises(ValueError) as t_info:
        th.CohortSampler(**kw)
    with pytest.raises(ValueError) as j_info:
        jh.CohortSampler(**kw)
    assert str(t_info.value) == str(j_info.value)


def test_as_cohort_sampler_matches_reference():
    assert th.as_cohort_sampler(None) is None
    assert th.as_cohort_sampler(0.25).fraction == 0.25
    assert th.as_cohort_sampler(7, seed=3) == th.CohortSampler(size=7, seed=3)
    s = th.CohortSampler(size=2)
    assert th.as_cohort_sampler(s) is s
    for bad in (True, "half"):
        assert _raised(lambda b=bad: th.as_cohort_sampler(b)) == \
            _raised(lambda b=bad: jh.as_cohort_sampler(b))


def test_partition_regions_round_robin_and_validation():
    ids = [f"c{i}" for i in range(5)]
    rr = th.partition_regions(ids, 2)
    assert rr == {"region0": ["c0", "c2", "c4"], "region1": ["c1", "c3"]}
    for regions in (2, 5, 1, {"eu": ids[:2], "us": ids[2:]}):
        assert th.partition_regions(ids, regions) == jh.partition_regions(ids, regions)
    for bad, match in ((0, "at least one region"), (9, "every region"),
                       ({"eu": ids, "empty": []}, "no clients"),
                       ({"eu": ids[:3], "us": ids[2:]}, "appears in regions"),
                       ({}, "empty")):
        with pytest.raises(ValueError, match=match):
            th.partition_regions(ids, bad)
        assert _raised(lambda b=bad: th.partition_regions(ids, b)) == \
            _raised(lambda b=bad: jh.partition_regions(ids, b))


# ---------------------------------------------------------------------------
# coordinator: events, carry-over, fault recovery
# ---------------------------------------------------------------------------

def test_coordinator_publishes_region_events():
    tres, jres = dyadic_results(6, seed=31)
    tbase, jbase = dyadic_base(32)
    rmap = th.partition_regions([r.client_id for r in tres], 3)
    bus, jbus = EventBus(), JaxBus()
    th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), bus=bus,
                            fold_cost_s=0.25).fold_round(2, tres, ta.InstantSchedule(),
                                                         base_params=tbase)
    jh.HierarchyCoordinator(rmap, agg_engine=jagg.AggregationEngine(), bus=jbus,
                            fold_cost_s=0.25).fold_round(2, jres, ja.InstantSchedule(),
                                                         base_params=jbase)
    closed = bus.events_of(RegionClosed)
    folded = bus.events_of(PartialFolded)
    assert [e.region for e in closed] == ["region0", "region1", "region2"]
    assert all(e.round_idx == 2 and e.n_folded == 2 for e in closed)
    assert [e.region for e in folded] == ["region0", "region1", "region2"]
    assert sum(e.weight for e in folded) == sum(r.n_samples for r in tres)
    assert sum(e.n_clients for e in folded) == 6
    assert all(e.base_round == 2 for e in folded)
    assert _trace(bus) == _trace(jbus)


def test_coordinator_satisfies_hierarchy_api():
    coord = th.HierarchyCoordinator({"r0": ["c0"]}, agg_engine=AggregationEngine())
    assert isinstance(coord, HierarchyAPI)
    assert isinstance(jh.HierarchyCoordinator({"r0": ["c0"]}), JaxHierarchyAPI)
    assert not isinstance(object(), HierarchyAPI)
    assert coord.region_of("c0") == "r0"
    assert coord.region("r0").client_ids == ["c0"]
    with pytest.raises(KeyError):
        coord.region_of("ghost")
    for bad in ({}, {"r0": []}, {"r0": ["c0"], "r1": ["c0"]}):
        assert _raised(lambda b=bad: th.HierarchyCoordinator(b)) == \
            _raised(lambda b=bad: jh.HierarchyCoordinator(b))


def test_region_deadline_parks_carry_in_the_region():
    """A region's straggler is parked in THAT region's carry buffer and
    folded into the region's next round at the discounted weight —
    matching the flat engine's carry math exactly."""
    tres, jres = dyadic_results(4, seed=41)
    tbase, jbase = dyadic_base(42)
    delays = {"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}
    rmap = {"east": ["c0", "c2"], "west": ["c1", "c3"]}
    kw = dict(carry_discount=0.5, fold_cost_s=0.125)
    coord = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine(),
                                    deadline=ta.FixedDeadline(t_round_s=2.0), **kw)
    flat = ta.AsyncRoundEngine(AggregationEngine(), deadline=ta.FixedDeadline(t_round_s=2.0), **kw)
    jcoord = jh.HierarchyCoordinator(rmap, agg_engine=jagg.AggregationEngine(),
                                     deadline=ja.FixedDeadline(t_round_s=2.0), **kw)
    for round_idx in (1, 2):
        r = coord.fold_round(round_idx, tres, ta.DeterministicSchedule(delays), base_params=tbase)
        f = flat.fold_round(round_idx, tres, ta.DeterministicSchedule(delays), base_params=tbase)
        j = jcoord.fold_round(round_idx, jres, ja.DeterministicSchedule(delays),
                              base_params=jbase)
        assert_bit_equal(r.params, f.params)
        assert_close_to_jax(r.params, j.params)
        assert_reports_equal(r, j)
        assert r.parent_fold_s >= 0.0 and r.region_reports.keys() == j.region_reports.keys()
        for rid in r.region_reports:
            assert_reports_equal(r.region_reports[rid], j.region_reports[rid])
        assert_partials_equal(r.partials, j.partials)
        if round_idx == 1:
            assert r.carried_over == ["c3"] == f.carried_over
            assert [rid for rid, _ in coord.pending_carryover()] == ["west"] == \
                [rid for rid, _ in jcoord.pending_carryover()]
        else:
            assert r.carried_in == ["c3"] == f.carried_in
            assert r.round_span_s >= 2.0


def test_region_revocation_replays_through_rerequest():
    """A revoked client inside one region recovers through the §4.3
    re-request path of that region's engine — the round still folds
    every client and matches the flat fold."""
    tres, jres = dyadic_results(4, seed=51)
    tbase, jbase = dyadic_base(52)
    delays = {"c0": 1.0, "c1": 2.0, "c2": 3.0, "c3": 6.0}
    rmap = th.partition_regions([r.client_id for r in tres], 2)
    report = th.HierarchyCoordinator(
        rmap, agg_engine=AggregationEngine(), recovery_delay_s=2.0, fold_cost_s=0.25,
    ).fold_round(1, tres, ta.DeterministicSchedule(delays, revoke_at={"c3": 1.5}),
                 base_params=tbase)
    jrep = jh.HierarchyCoordinator(
        rmap, agg_engine=jagg.AggregationEngine(), recovery_delay_s=2.0, fold_cost_s=0.25,
    ).fold_round(1, jres, ja.DeterministicSchedule(delays, revoke_at={"c3": 1.5}),
                 base_params=jbase)
    assert report.rerequested == ["c3"]
    rid = "region1"
    assert report.region_reports[rid].rerequested == ["c3"]
    attempts = {e.client_id: e.attempt for e in report.region_reports[rid].events}
    assert attempts["c3"] == 2
    assert_bit_equal(report.params, flat_fold(tres, tbase))
    assert_reports_equal(report, jrep)
    assert_close_to_jax(report.params, jrep.params)


def test_fold_round_requires_base_and_mapped_clients():
    tres, jres = dyadic_results(2, seed=61)
    rmap = th.partition_regions([r.client_id for r in tres], 2)
    coord = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine())
    jcoord = jh.HierarchyCoordinator(rmap, agg_engine=jagg.AggregationEngine())
    with pytest.raises(ValueError, match="base_params"):
        coord.fold_round(0, tres, ta.InstantSchedule())
    assert _raised(lambda: coord.fold_round(0, tres, ta.InstantSchedule())) == \
        _raised(lambda: jcoord.fold_round(0, jres, ja.InstantSchedule()))
    tbase, jbase = dyadic_base(62)
    tstray, jstray = (res[2] for res in dyadic_results(3, seed=63))
    with pytest.raises(KeyError, match="c2"):
        coord.fold_round(0, tres + [tstray], ta.InstantSchedule(), base_params=tbase)
    assert _raised(lambda: coord.fold_round(0, tres + [tstray], base_params=tbase)) == \
        _raised(lambda: jcoord.fold_round(0, jres + [jstray], base_params=jbase))
    with pytest.raises(ValueError, match="no partial sums"):
        coord.fold_partials(0, [], tbase)


# ---------------------------------------------------------------------------
# HierarchicalFLServer end-to-end
# ---------------------------------------------------------------------------

class _Stub:
    """The port's StubClient: fixed params, no training."""

    def __init__(self, result):
        self.client_id = result.client_id
        self._result = result

    def train(self, global_params):
        return self._result

    def evaluate(self, aggregated_params):
        return EvalResult(self.client_id, {"loss": 1.0}, self._result.n_samples, 0.0)


_TIME_FIELDS = {"time_s", "span_s", "overhead_s"}


def _server_trace(bus):
    """Server lifecycle events are on the wall clock: compare them without
    their times (fold events keep theirs: fold_cost_s is fixed)."""
    out = []
    for e in bus.trace:
        d = dataclasses.asdict(e)
        if type(e).__name__ in ("RoundDispatched", "CheckpointSaved", "RecoveryCompleted"):
            d = {k: v for k, v in d.items() if k not in _TIME_FIELDS}
        out.append((type(e).__name__, d))
    return out


def test_hierarchical_server_matches_flat_server_with_carry():
    """Three rounds with a deadline, carry-over and fp16 wire: the
    hierarchical server within 1e-6 of the flat AsyncFLServer (round 1
    bit-equal), and of the reference's hierarchical server, with equal
    traces and wire bytes."""
    tres, jres = dyadic_results(4, seed=71)
    tinit, jinit = dyadic_base(72)
    delays = {"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}
    kw = dict(carry_discount=0.5, compression="fp16", fold_cost_s=0.125)
    rounds1 = []
    flat_server = ta.AsyncFLServer(
        [_Stub(r) for r in tres], tinit, schedule=ta.DeterministicSchedule(delays),
        round_deadline=ta.FixedDeadline(t_round_s=2.0), device="cpu",
        post_round_hook=lambda r, p: rounds1.append(p) if r == 1 else None, **kw)
    flat = flat_server.run(3)
    hrounds1 = []
    hier_server = th.HierarchicalFLServer(
        [_Stub(r) for r in tres], tinit, schedule=ta.DeterministicSchedule(delays), regions=2,
        round_deadline=ta.FixedDeadline(t_round_s=2.0), device="cpu",
        post_round_hook=lambda r, p: hrounds1.append(p) if r == 1 else None, **kw)
    hier = hier_server.run(3)
    jserver = jh.HierarchicalFLServer(
        [StubClient(r) for r in jres], jinit, schedule=ja.DeterministicSchedule(delays),
        regions=2, round_deadline=ja.FixedDeadline(t_round_s=2.0), **kw)
    jrun = jserver.run(3)
    assert_bit_equal(hrounds1[0], rounds1[0])
    for a, b in zip(tree_flatten(hier.final_params)[0], tree_flatten(flat.final_params)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    assert_close_to_jax(hier.final_params, jrun.final_params)
    assert len(hier_server.fold_reports) == 3
    assert hier_server.fold_reports[0].region_reports.keys() == {"region0", "region1"}
    assert _server_trace(hier_server.bus) == _server_trace(jserver.bus)
    for t, j in zip(hier_server.fold_reports, jserver.fold_reports):
        assert_reports_equal(t, j)
        assert_partials_equal(t.partials, j.partials)
    assert hier_server.agg_engine.stats.total_wire_bytes == \
        jserver.agg_engine.stats.total_wire_bytes
    assert [(c.client_id, c.origin_round) for _, c in hier_server.coordinator.pending_carryover()] \
        == [(c.client_id, c.origin_round) for _, c in jserver.coordinator.pending_carryover()]


def test_hierarchical_server_cohort_rounds():
    tres, jres = dyadic_results(10, seed=81)
    tinit, jinit = dyadic_base(82)
    server = th.HierarchicalFLServer([_Stub(r) for r in tres], tinit, regions=2, cohort=0.5,
                                     cohort_seed=9, device="cpu")
    run = server.run(3)
    jserver = jh.HierarchicalFLServer([StubClient(r) for r in jres], jinit, regions=2,
                                      cohort=0.5, cohort_seed=9)
    jrun = jserver.run(3)
    for round_idx, (report, jrep) in enumerate(zip(server.fold_reports, jserver.fold_reports),
                                               start=1):
        cohort = server.coordinator.cohort_for(round_idx, [r.client_id for r in tres])
        assert len(cohort) == 5
        assert sorted(report.fold_times) == sorted(cohort) == sorted(jrep.fold_times)
    assert len(server.clients) == 10  # population list restored after every round
    assert_close_to_jax(run.final_params, jrun.final_params)


def test_hierarchical_server_mapping_regions_and_events():
    tres, jres = dyadic_results(4, seed=91)
    tinit, jinit = dyadic_base(92)
    regions = {"eu": ["c0", "c1"], "us": ["c2", "c3"]}
    server = th.HierarchicalFLServer([_Stub(r) for r in tres], tinit, regions=regions,
                                     fold_cost_s=0.25, device="cpu")
    server.run(1)
    jserver = jh.HierarchicalFLServer([StubClient(r) for r in jres], jinit, regions=regions,
                                      fold_cost_s=0.25)
    jserver.run(1)
    assert server.region_ids == ["eu", "us"] == jserver.region_ids
    assert [e.region for e in server.bus.events_of(RegionClosed)] == ["eu", "us"]
    assert [e.region for e in server.bus.events_of(PartialFolded)] == ["eu", "us"]
    assert _server_trace(server.bus) == _server_trace(jserver.bus)


def test_hierarchical_server_params_follow_the_device_asked_for():
    """The server keeps its params where ``device`` says (the card by
    default); asked for the CPU, every level stays there."""
    tres, _ = dyadic_results(3, seed=93)
    tinit, _ = dyadic_base(94)
    server = th.HierarchicalFLServer([_Stub(r) for r in tres], tinit, regions=2, device="cpu")
    run = server.run(1)
    assert all(v.device.type == "cpu" for v in run.final_params.values())
    assert all(p.acc.device.type == "cpu" for p in server.fold_reports[0].partials)
    assert server.device == torch.device("cpu")
    import inspect

    from repro_torch.federated.server import FLServer
    assert inspect.signature(FLServer).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# Experiment builder surface
# ---------------------------------------------------------------------------

def test_experiment_hierarchy_serves_hierarchical_server():
    """The reference's test, and the reference's chain on the same draws:
    params within 1e-6 and equal traces."""
    from repro.core import Experiment as JaxExperiment

    tres, jres = dyadic_results(6, seed=101)
    tinit, jinit = dyadic_base(102)
    server = (
        Experiment()
        .hierarchy(regions=3, cohort=th.CohortSampler(size=4, seed=2))
        .serve([_Stub(r) for r in tres], tinit, fold_cost_s=0.25, device="cpu")
    )
    assert isinstance(server, th.HierarchicalFLServer)
    assert server.region_ids == ["region0", "region1", "region2"]
    run = server.run(2)
    assert len(run.rounds) == 2
    jserver = (
        JaxExperiment()
        .hierarchy(regions=3, cohort=jh.CohortSampler(size=4, seed=2))
        .serve([StubClient(r) for r in jres], jinit, fold_cost_s=0.25)
    )
    jrun = jserver.run(2)
    assert_close_to_jax(run.final_params, jrun.final_params)
    assert _server_trace(server.bus) == _server_trace(jserver.bus)


def test_experiment_hierarchy_validates_at_chain_time():
    with pytest.raises(ValueError, match="at least one region"):
        Experiment().hierarchy(regions=0)
    with pytest.raises(TypeError, match="regions"):
        Experiment().hierarchy(regions=True)
    with pytest.raises(ValueError, match="empty"):
        Experiment().hierarchy(regions={})
    with pytest.raises(ValueError, match="fraction"):
        Experiment().hierarchy(regions=2, cohort=2.0)


def test_experiment_hierarchy_rejected_off_target():
    with pytest.raises(ValueError, match="in-process"):
        Experiment().transport().hierarchy(2).serve([], {}, device="cpu")
    env_needed = Experiment().hierarchy(2)
    with pytest.raises(ValueError):
        env_needed.build()  # simulator target refuses (no env, and no
        #                     hierarchy support even with one)


def test_structured_hierarchy_matches_dense_hierarchy():
    """Structured regional partials (a full-coverage schema, fp16 wire)
    through the coordinator, sequential and sharded: bit-equal to the
    dense hierarchy over the same split, and within 1e-6 of the
    reference's structured hierarchy."""
    tres, jres = dyadic_results(6, seed=101)
    tbase, jbase = dyadic_base(102)
    rmap = th.partition_regions([r.client_id for r in tres], 3)
    dense = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine()).fold_round(
        0, tres, ta.InstantSchedule(), base_params=tbase)
    schema = {"a": "leaf0", "b": "leaf1"}
    for sharded in (False, True):
        coord = th.HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), schema=schema,
                                        sharded=sharded)
        got = coord.fold_round(0, tres, ta.InstantSchedule(), base_params=tbase)
        assert_bit_equal(got.params, dense.params)
        assert [p.n_clients for p in got.partials] == [2, 2, 2]
        jgot = jh.HierarchyCoordinator(rmap, agg_engine=jagg.AggregationEngine(), schema=schema,
                                       sharded=sharded).fold_round(
            0, jres, ja.InstantSchedule(), base_params=jbase)
        assert_close_to_jax(got.params, jgot.params)
        assert [(p.region_id, p.wire_bytes, p.group_wsums()) for p in got.partials] == \
            [(p.region_id, p.wire_bytes, p.group_wsums()) for p in jgot.partials]
