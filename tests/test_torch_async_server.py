"""The port's async round engine and AsyncFLServer against the reference's.

Every scenario runs in both packages on the same numpy-seeded client
results (tests/conftest.py's builders, converted leaf by leaf).  With the
fold cost fixed (``fold_cost_s``) the virtual clock is pure arithmetic,
so every ``FoldReport`` field but the params, and every event on the
bus, must be equal, times included.  Params agree within 2e-5 in fp32
(the folds sum in another order) and 2e-2 in bf16, the kernel
tolerances of tests/test_kernels.py.

The last section runs a reduced-FEMNIST ``AsyncFLServer`` per codec in
both packages, with one slow silo, a deadline and carry-over: traces and
message logs equal, params within 1e-4 (see ``_femnist_runs``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_results
from repro.core.revocation import RevocationModel as JaxRevocationModel
from repro.federated import async_server as ja
from repro.federated.agg_engine import AggregationEngine as JaxEngine
from repro.federated.agg_engine import DriftAwareDiscount as JaxDrift
from repro.federated.client import ClientResult as JaxResult
from repro.federated.client import EvalResult as JaxEval
from repro_torch.convert import params_from_numpy
from repro_torch.core.revocation import RevocationModel
from repro_torch.federated import async_server as ta
from repro_torch.federated.agg_engine import (
    AggregationEngine,
    CarryEntry,
    DriftAwareDiscount,
)
from repro_torch.federated.client import ClientResult, EvalResult
from repro_torch.federated.compression import CompressedUpdate, CompressionSpec, compress
from repro_torch.utils.tree import path_str, tree_flatten_with_path


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _port_results(results):
    return [ClientResult(r.client_id, _port(r.params), r.n_samples, r.train_time_s)
            for r in results]


def _assert_same_tree(got, want, atol=2e-5):
    pairs, _ = tree_flatten_with_path(got)
    jpairs = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(pairs) == len(jpairs)
    for (path, t), (_, j) in zip(pairs, jpairs):
        assert tuple(t.shape) == j.shape, path_str(path)
        assert str(t.dtype)[6:] == j.dtype.name, path_str(path)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   atol=atol, rtol=atol, err_msg=path_str(path))


_REPORT_FIELDS = ("excluded", "rerequested", "fold_times", "round_span_s", "busy_s", "idle_s",
                  "barrier_span_s", "deadline_s", "policy_deadline_s", "carried_over",
                  "carried_in", "escalations")


def _assert_reports_equal(got, want, atol=2e-5):
    assert [dataclasses.asdict(e) for e in got.events] == \
        [dataclasses.asdict(e) for e in want.events]
    for f in _REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.span_saved_s == want.span_saved_s
    _assert_same_tree(got.params, want.params, atol)


def _trace(bus):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in bus.trace]


def _both_engines(**kw):
    """(port engine, reference engine) with the same settings; the
    deadline/staleness objects are built per package by the caller."""
    jkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    tkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    return ta.AsyncRoundEngine(**tkw), ja.AsyncRoundEngine(**jkw)


def _run_rounds(tengine, jengine, results, tsched, jsched, n_rounds=1, **fold_kw):
    tres = _port_results(results)
    reports = []
    for r in range(1, n_rounds + 1):
        got = tengine.fold_round(r, tres, tsched, **fold_kw)
        want = jengine.fold_round(r, results, jsched, **fold_kw)
        _assert_reports_equal(got, want)
        reports.append(got)
    assert _trace(tengine.bus) == _trace(jengine.bus)
    assert tengine.carry.clients() == jengine.carry.clients()
    assert tengine.carry.pending_weight() == jengine.carry.pending_weight()
    return reports


def _sched(delays, revoke_at=None):
    return ta.DeterministicSchedule(delays, revoke_at), ja.DeterministicSchedule(delays, revoke_at)


# ---------------------------------------------------------------------------
# Streaming fold vs the reference, and vs the barrier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_streaming_fold_matches_reference_any_arrival_order(seed, dtype):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    results = make_results(n, dtype=dtype, seed=seed)
    delays = {r.client_id: float(d) for r, d in zip(results, rng.permutation(n))}
    tengine, jengine = _both_engines(fold_cost_s=0.1)
    tres = _port_results(results)
    got = tengine.fold_round(1, tres, ta.DeterministicSchedule(delays))
    want = jengine.fold_round(1, results, ja.DeterministicSchedule(delays))
    atol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    _assert_reports_equal(got, want, atol)
    assert _trace(tengine.bus) == _trace(jengine.bus)
    # ... and the same average the barrier's fused reduce computes.
    barrier = AggregationEngine().aggregate([r.params for r in tres], [r.n_samples for r in tres])
    for a, b in zip(_leaves(got.params), _leaves(barrier)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=atol, rtol=atol)


def _leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def test_straggler_folds_hide_behind_arrival():
    """1 straggler in 4: the streaming span is the straggler's arrival plus
    ONE fold; the barrier span pays all folds after it."""
    results = make_results(4)
    tengine, jengine = _both_engines(fold_cost_s=0.5)
    (report,) = _run_rounds(tengine, jengine, results,
                            *_sched({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}))
    assert report.round_span_s == pytest.approx(5.5)
    assert report.barrier_span_s == pytest.approx(7.0)
    assert report.idle_s == pytest.approx(3.5)
    assert report.fold_times["c2"] == pytest.approx(2.5)


def test_heavy_tail_schedule_draws_the_reference_arrivals():
    results = make_results(5, seed=3)
    ids = [r.client_id for r in results]
    tsched = ta.HeavyTailSchedule(base_s=1.0, straggler_ids=("c2",), straggler_prob=0.2, seed=7)
    jsched = ja.HeavyTailSchedule(base_s=1.0, straggler_ids=("c2",), straggler_prob=0.2, seed=7)
    for r in range(3):
        got = tsched.round_arrivals(r, ids)
        want = jsched.round_arrivals(r, ids)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}
    tengine, jengine = _both_engines(fold_cost_s=0.01)
    _run_rounds(tengine, jengine, results, tsched, jsched, n_rounds=2)


def test_degenerate_schedule_is_one_batch_reduce():
    engine = AggregationEngine()
    round_engine = ta.AsyncRoundEngine(engine)
    for r in range(3):
        report = round_engine.fold_round(r + 1, _port_results(make_results(3, seed=r)),
                                         ta.InstantSchedule())
        assert report.idle_s == 0.0 and not report.excluded
    assert engine.stats.n_calls == 3


# ---------------------------------------------------------------------------
# Deadlines and carry-over
# ---------------------------------------------------------------------------

class _CostModel:
    """The one method CostModelDeadline reads (the cost model itself comes
    with the port's builder)."""

    def deadline_from_t_max(self, frac):
        return 4.0 * frac


def _policies(kind):
    if kind == "fixed":
        return ta.FixedDeadline(t_round_s=2.0), ja.FixedDeadline(t_round_s=2.0)
    if kind == "fixed_late":
        return ta.FixedDeadline(t_round_s=50.0), ja.FixedDeadline(t_round_s=50.0)
    if kind == "quantile_quorum":
        return (ta.QuantileDeadline(q=0.5, min_clients=4),
                ja.QuantileDeadline(q=0.5, min_clients=4))
    if kind == "weight_quorum":
        return (ta.FixedDeadline(t_round_s=2.0, min_weight_frac=0.7),
                ja.FixedDeadline(t_round_s=2.0, min_weight_frac=0.7))
    if kind == "callable":
        fn = lambda r, offsets: 0.5 * max(offsets.values())  # noqa: E731
        return ta.CallableDeadline(fn=fn), ja.CallableDeadline(fn=fn)
    cm = _CostModel()
    return (ta.CostModelDeadline(cost_model=cm, frac=0.5),
            ja.CostModelDeadline(cost_model=cm, frac=0.5))


@pytest.mark.parametrize("kind", ["fixed", "fixed_late", "quantile_quorum", "weight_quorum",
                                  "callable", "cost_model"])
def test_deadline_rounds_match_reference(kind):
    """Two rounds with c3 5x slow: the effective deadline, what is parked,
    what is carried in at half weight, and the counterfactual barrier."""
    results = make_results(4)
    tengine, jengine = _both_engines(fold_cost_s=0.1, deadline=_policies(kind),
                                     carry_discount=0.5)
    reports = _run_rounds(tengine, jengine, results,
                          *_sched({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}), n_rounds=2)
    if kind in ("fixed", "callable", "cost_model"):
        assert reports[0].carried_over == ["c3"] and reports[1].carried_in == ["c3"]
        stale = [e for e in reports[1].events if e.is_stale]
        assert [(e.weight, e.folded_weight, e.origin_round) for e in stale] == [(40.0, 20.0, 1)]
    else:
        assert reports[0].carried_over == [] and reports[1].carried_in == []


def test_deadline_policy_validation_matches_reference():
    for mod in (ta, ja):
        with pytest.raises(ValueError):
            mod.FixedDeadline(t_round_s=1.0, min_clients=0)
        with pytest.raises(ValueError):
            mod.QuantileDeadline(q=0.5, min_weight_frac=1.5)
        with pytest.raises(ValueError):
            mod.AsyncRoundEngine(carry_discount=2.0)
        with pytest.raises(ValueError):
            mod.AsyncRoundEngine(escalate_after=0)
        with pytest.raises(ValueError):
            mod.AsyncRoundEngine(on_revocation="drop-table")
        with pytest.raises(ValueError):
            mod.CostModelDeadline(cost_model=None).deadline_s(1, {})


def _assert_weight_conserved(engine, reports, results, n_rounds):
    folded = sum(e.weight for rep in reports for e in rep.events)
    total = sum(r.n_samples for r in results)
    assert folded + engine.carry.pending_weight() == pytest.approx(n_rounds * total)
    seen = set()
    for rep in reports:
        for e in rep.events:
            if e.is_stale:
                assert (e.client_id, e.origin_round) not in seen
                seen.add((e.client_id, e.origin_round))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_carryover_conserves_weight_like_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    results = make_results(n, seed=seed, weights=[int(w) for w in rng.integers(1, 100, n)])
    delays = {r.client_id: float(d) for r, d in zip(results, rng.uniform(0, 10, n))}
    t_round, min_clients = float(rng.uniform(0, 12)), int(rng.integers(1, n + 1))
    discount = float(rng.uniform(0, 1))
    tengine, jengine = _both_engines(
        fold_cost_s=0.05, carry_discount=discount,
        deadline=(ta.FixedDeadline(t_round_s=t_round, min_clients=min_clients),
                  ja.FixedDeadline(t_round_s=t_round, min_clients=min_clients)))
    reports = _run_rounds(tengine, jengine, results, *_sched(delays), n_rounds=3)
    _assert_weight_conserved(tengine, reports, results, 3)


def test_drift_aware_discount_matches_reference():
    """A carried-in update under DriftAwareDiscount: the multiplier reads the
    L2 drift of the base, which the two packages sum in other orders, so
    the folded weight agrees to rounding, not bit for bit."""
    results = make_results(3, seed=5)
    rng = np.random.default_rng(1)
    bases = [{"leaf0": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
              "leaf1": jnp.asarray(rng.standard_normal(7), jnp.float32)} for _ in range(2)]
    tengine, jengine = _both_engines(
        fold_cost_s=0.1, deadline=(ta.FixedDeadline(t_round_s=2.0), ja.FixedDeadline(t_round_s=2.0)),
        staleness_policy=(DriftAwareDiscount(0.5, 2.0), JaxDrift(0.5, 2.0)))
    tres = _port_results(results)
    tsched, jsched = _sched({"c0": 1.0, "c1": 1.0, "c2": 5.0})
    for r, base in enumerate(bases, start=1):
        got = tengine.fold_round(r, tres, tsched, base_params=_port(base))
        want = jengine.fold_round(r, results, jsched, base_params=base)
        _assert_same_tree(got.params, want.params)
    (tstale,) = [e for e in got.events if e.is_stale]
    (jstale,) = [e for e in want.events if e.is_stale]
    assert tstale.folded_weight == pytest.approx(jstale.folded_weight, rel=1e-5)
    assert tstale.folded_weight < 0.5 * tstale.weight


# ---------------------------------------------------------------------------
# Revocations (§4.3 re-request / exclude)
# ---------------------------------------------------------------------------

_REVOCATIONS = {
    "rerequest": ({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}, {"c3": 2.0},
                  dict(fold_cost_s=0.5, recovery_delay_s=1.0)),
    "exclude": ({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}, {"c3": 2.0},
                dict(fold_cost_s=0.5, on_revocation="exclude")),
    "after_delivery": ({"c0": 1.0, "c1": 2.0, "c2": 3.0}, {"c1": 2.5}, dict(fold_cost_s=0.1)),
    "budget_exhausted": ({"c0": 1.0, "c1": 4.0}, {"c1": 0.5},
                         dict(fold_cost_s=0.1, max_rerequests=0)),
    "at_arrival": ({"c0": 1.0, "c1": 3.0}, {"c1": 3.0},
                   dict(fold_cost_s=0.1, recovery_delay_s=0.5)),
    "mid_fold_quorum": ({"c0": 0.5, "c1": 2.0, "c2": 1.0}, {"c1": 1.0},
                        dict(fold_cost_s=1.0, recovery_delay_s=0.5,
                             deadline=(ta.FixedDeadline(t_round_s=10.0, min_clients=3),
                                       ja.FixedDeadline(t_round_s=10.0, min_clients=3)))),
    "on_deadline_tick": ({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}, {"c3": 2.0},
                         dict(fold_cost_s=0.1, recovery_delay_s=1.0, carry_discount=0.5,
                              deadline=(ta.FixedDeadline(t_round_s=2.0),
                                        ja.FixedDeadline(t_round_s=2.0)))),
}


@pytest.mark.parametrize("name", sorted(_REVOCATIONS))
def test_revocations_match_reference(name):
    delays, revoke_at, kw = _REVOCATIONS[name]
    results = make_results(len(delays))
    tengine, jengine = _both_engines(**kw)
    (report,) = _run_rounds(tengine, jengine, results, *_sched(delays, revoke_at))
    names = {type(e).__name__ for e in tengine.bus.trace}
    assert ("RevocationOccurred" in names) == (name != "after_delivery")
    if name == "rerequest":
        assert report.rerequested == ["c3"] and report.fold_times["c3"] == pytest.approx(8.5)
    if name == "exclude":
        assert report.excluded == ["c3"]


def test_all_silos_revoked_raises_in_both():
    results = make_results(2)
    tsched, jsched = _sched({"c0": 1.0, "c1": 1.0}, {"c0": 0.1, "c1": 0.1})
    with pytest.raises(ValueError, match="nothing to fold"):
        ta.AsyncRoundEngine(fold_cost_s=0.1, on_revocation="exclude").fold_round(
            1, _port_results(results), tsched)
    with pytest.raises(ValueError, match="nothing to fold"):
        ja.AsyncRoundEngine(fold_cost_s=0.1, on_revocation="exclude").fold_round(
            1, results, jsched)


def test_revocation_injector_draws_the_reference_revocations():
    inner = {"c0": 1.0, "c1": 50.0, "c2": 50.0}
    tinj = ta.RevocationInjector(ta.DeterministicSchedule(inner), RevocationModel(k_r=5.0, seed=3),
                                 spot_clients=("c1",), horizon_s=50.0)
    jinj = ja.RevocationInjector(ja.DeterministicSchedule(inner),
                                 JaxRevocationModel(k_r=5.0, seed=3),
                                 spot_clients=("c1",), horizon_s=50.0)
    hit = False
    for r in range(5):
        got = tinj.round_arrivals(r, list(inner))
        want = jinj.round_arrivals(r, list(inner))
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}
        hit |= got["c1"].revoke_at_s is not None
        assert got["c2"].revoke_at_s is None
    assert hit


def test_recorded_rearrival_is_replayed():
    """A measured re-request arrival (live transport) replaces the model;
    an infinite one excludes the silo."""
    results = make_results(3)
    arrivals = {"c0": (1.0, None, None), "c1": (2.0, 1.5, 7.25), "c2": (2.0, 1.0, math.inf)}

    class Recorded:
        def __init__(self, mod):
            self.mod = mod

        def round_arrivals(self, round_idx, ids):
            return {cid: self.mod.ClientArrival(cid, *arrivals[cid]) for cid in ids}

    tengine, jengine = _both_engines(fold_cost_s=0.1)
    (report,) = _run_rounds(tengine, jengine, results, Recorded(ta), Recorded(ja))
    assert report.fold_times["c1"] == pytest.approx(7.35) and report.excluded == ["c2"]


# ---------------------------------------------------------------------------
# AsyncFLServer: escalation, revocations end to end
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, result, eval_cls):
        self.client_id = result.client_id
        self._result = result
        self._eval_cls = eval_cls

    def train(self, global_params):
        return self._result

    def evaluate(self, aggregated_params):
        return self._eval_cls(self.client_id, {"loss": 1.0}, self._result.n_samples, 0.0)


def _servers(results, **kw):
    tkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    jkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    tres = _port_results(results)
    tserver = ta.AsyncFLServer([_Stub(r, EvalResult) for r in tres], tres[0].params,
                               device="cpu", **tkw)
    jserver = ja.AsyncFLServer([_Stub(r, JaxEval) for r in results], results[0].params, **jkw)
    return tserver, jserver


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


def test_escalation_hook_matches_reference():
    results = make_results(3)
    decisions = {"t": [], "j": []}
    tserver, jserver = _servers(
        results, schedule=_sched({"c0": 1.0, "c1": 1.0, "c2": 9.0}), fold_cost_s=0.1,
        round_deadline=(ta.FixedDeadline(t_round_s=2.0), ja.FixedDeadline(t_round_s=2.0)),
        escalate_after=2,
        on_straggler=(lambda c, r: decisions["t"].append((c, r)),
                      lambda c, r: decisions["j"].append((c, r))))
    trun, jrun = tserver.run(3), jserver.run(3)
    assert decisions["t"] == decisions["j"] == [("c2", 2)]
    assert [rep.escalations for rep in tserver.fold_reports] == [[], ["c2"], []]
    assert _server_trace(tserver.bus) == _server_trace(jserver.bus)
    for t, j in zip(trun.rounds, jrun.rounds):
        assert (t.fold_times_s, t.round_span_s, t.idle_s, t.deadline_s, t.carried_over,
                t.carried_in) == (j.fold_times_s, j.round_span_s, j.idle_s, j.deadline_s,
                                  j.carried_over, j.carried_in)
    _assert_same_tree(trun.final_params, jrun.final_params)
    assert tserver.pending_carryover.clients() == jserver.pending_carryover.clients() == ["c2"]


def test_async_server_with_revocations_matches_reference():
    results = make_results(4, seed=9)
    tserver, jserver = _servers(
        results, schedule=_sched({"c0": 1.0, "c1": 2.0, "c2": 3.0, "c3": 6.0}, {"c3": 1.5}),
        fold_cost_s=0.2, recovery_delay_s=2.0)
    trun, jrun = tserver.run(1), jserver.run(1)
    assert tserver.fold_reports[0].rerequested == ["c3"]
    assert trun.rounds[0].fold_times_s == jrun.rounds[0].fold_times_s
    assert trun.rounds[0].fold_times_s["c3"] == pytest.approx(9.7)
    _assert_same_tree(trun.final_params, jrun.final_params)
    assert _server_trace(tserver.bus) == _server_trace(jserver.bus)


def test_later_items_still_raise():
    """The branches that raised until the hierarchy was ported now export
    partial sums as the reference does: a dense and a structured
    aggregator's ``export_partial`` and ``fold_round(emit_partial=True)``
    (params None, the partial on the report, the trace equal).  What
    still raises is what raises in the reference: an empty export, and
    ``emit_partial`` without a delta base (ValueError, same message)."""
    results = make_results(3, seed=4)
    tres = _port_results(results)
    base, jbase = tres[0].params, results[0].params
    for schema in (None, {"a": "leaf0"}):
        agg = AggregationEngine().streaming(base=base, base_round=1, schema=schema)
        jagg_ = JaxEngine().streaming(base=jbase, base_round=1, schema=schema)
        with pytest.raises(ValueError, match="no clients") as info:
            agg.export_partial()
        with pytest.raises(ValueError) as jinfo:
            jagg_.export_partial()
        assert str(info.value) == str(jinfo.value)
        for r, j in zip(tres, results):
            agg.add(r.params, r.n_samples)
            jagg_.add(j.params, j.n_samples)
        p, jp = agg.export_partial("r"), jagg_.export_partial("r")
        parts = [p] if schema is None else [g for _, g in p.groups]
        jparts = [jp] if schema is None else [g for _, g in jp.groups]
        assert [(q.n_clients, q.wsum, q.plan_signature, q.wire_bytes) for q in parts] == \
            [(q.n_clients, q.wsum, q.plan_signature, q.wire_bytes) for q in jparts]
        for q, jq in zip(parts, jparts):
            np.testing.assert_allclose(q.acc.numpy(), np.asarray(jq.acc), atol=2e-5, rtol=2e-5)
    kw = dict(fold_cost_s=0.25)
    with pytest.raises(ValueError, match="emit_partial requires base_params") as info:
        ta.AsyncRoundEngine(**kw).fold_round(1, tres, ta.InstantSchedule(), emit_partial=True)
    with pytest.raises(ValueError) as jinfo:
        ja.AsyncRoundEngine(**kw).fold_round(1, results, ja.InstantSchedule(), emit_partial=True)
    assert str(info.value) == str(jinfo.value)
    tengine, jengine = ta.AsyncRoundEngine(**kw), ja.AsyncRoundEngine(**kw)
    rep = tengine.fold_round(1, tres, ta.InstantSchedule(), base_params=base, emit_partial=True)
    jrep = jengine.fold_round(1, results, ja.InstantSchedule(), base_params=jbase,
                              emit_partial=True)
    assert rep.params is None and jrep.params is None
    assert (rep.partial.n_clients, rep.partial.wsum, rep.partial.base_round,
            rep.partial.wire_bytes) == (jrep.partial.n_clients, jrep.partial.wsum,
                                        jrep.partial.base_round, jrep.partial.wire_bytes)
    np.testing.assert_allclose(rep.partial.acc.numpy(), np.asarray(jrep.partial.acc),
                               atol=2e-5, rtol=2e-5)
    assert _trace(tengine.bus) == _trace(jengine.bus)


# ---------------------------------------------------------------------------
# Compressed carry-over is materialized at park time (tests/test_async_server.py:723)
# ---------------------------------------------------------------------------

def test_compressed_carry_is_materialized_dense_at_park():
    from repro.federated.agg_engine import plan_for as jax_plan_for
    from repro.federated.compression import CompressionSpec as JaxSpec
    from repro.federated.compression import compress as jax_compress

    rng = np.random.default_rng(0)
    base0 = {"w": jnp.asarray(rng.standard_normal(32), jnp.float32)}
    base1 = {"w": jnp.asarray(rng.standard_normal(32), jnp.float32)}
    dense = {cid: {"w": jnp.asarray(rng.standard_normal(32), jnp.float32)} for cid in ("c0", "c1")}
    jplan = jax_plan_for(base0)

    def delta(params, base):
        return np.asarray(jplan.flatten(params)) - np.asarray(jplan.flatten(base))

    def both(cid, base, r, n):
        d = delta(dense[cid], base)
        return (ClientResult(cid, compress(d, CompressionSpec("fp16"), base_round=r), n, 0.0),
                JaxResult(cid, jax_compress(d, JaxSpec("fp16"), base_round=r), n, 0.0))

    tengine, jengine = _both_engines(
        deadline=(ta.FixedDeadline(t_round_s=2.0), ja.FixedDeadline(t_round_s=2.0)),
        carry_discount=0.5, fold_cost_s=0.1)
    r1 = [both("c0", base0, 1, 10), both("c1", base0, 1, 30)]
    tsched, jsched = _sched({"c0": 1.0, "c1": 9.0})
    got1 = tengine.fold_round(1, [t for t, _ in r1], tsched, base_params=_port(base0))
    want1 = jengine.fold_round(1, [j for _, j in r1], jsched, base_params=base0)
    _assert_reports_equal(got1, want1)
    (entry,) = tengine.carry.snapshot()
    assert isinstance(entry, CarryEntry) and not isinstance(entry.params, CompressedUpdate)
    np.testing.assert_allclose(entry.params["w"].numpy(), np.asarray(dense["c1"]["w"]),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(entry.params["w"].numpy(),
                                  np.asarray(jengine.carry.snapshot()[0].params["w"]))

    r2 = [both("c0", base1, 2, 10)]
    got2 = tengine.fold_round(2, [r2[0][0]], ta.InstantSchedule(), base_params=_port(base1))
    want2 = jengine.fold_round(2, [r2[0][1]], ja.InstantSchedule(), base_params=base1)
    _assert_reports_equal(got2, want2)
    assert got2.carried_in == ["c1"]
    assert _trace(tengine.bus) == _trace(jengine.bus)
    want = (10 * np.asarray(dense["c0"]["w"]) + 15 * np.asarray(dense["c1"]["w"])) / 25
    np.testing.assert_allclose(got2.params["w"].numpy(), want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# Reduced FEMNIST AsyncFLServer, per codec, in both packages
# ---------------------------------------------------------------------------

FEMNIST_SAMPLES = [(48, 16), (32, 16), (40, 32)]
FEMNIST_ROUNDS = 3
FEMNIST_LR = 1e-3
# One slow silo: client_2's c_msg_train lands after the deadline every
# round, so its compressed update is materialized at park and carried
# into the next round (and, escalate_after=2, escalated in round 2).
FEMNIST_DELAYS = {"client_0": 1.0, "client_1": 1.5, "client_2": 6.0}
PARAM_TOL = 1e-4


def _femnist_jax(codec, params0):
    from repro.data import make_classification_silos as jax_silos
    from repro.federated import FLClient as JaxClient
    from repro.models import fl_models as jm
    from repro.optim import make_optimizer as jax_make_optimizer

    cfg = jm.FemnistConfig(n_fc=2, fc_width=64)

    def loss_fn(p, b):
        return jm.softmax_cross_entropy(jm.femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = jm.femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": jnp.mean((jnp.argmax(logits, -1) == b[1]).astype(jnp.float32)) * n,
                "loss_sum": jm.softmax_cross_entropy(logits, b[1]) * n}

    opt = jax_make_optimizer("sgdm", FEMNIST_LR)
    clients = [JaxClient(s.client_id, s, loss_fn, opt, batch_size=16, eval_fn=eval_fn,
                         batch_fn=lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
               for s in jax_silos(3, 62, (28, 28, 1), FEMNIST_SAMPLES, seed=0)]
    server = ja.AsyncFLServer(
        clients, params0, schedule=ja.DeterministicSchedule(FEMNIST_DELAYS), fold_cost_s=0.01,
        round_deadline=ja.FixedDeadline(t_round_s=3.0), compression=codec,
        measure_round_messages=True)
    return server, server.run(FEMNIST_ROUNDS)


def _femnist_port(codec, params0):
    from repro_torch.data import make_classification_silos
    from repro_torch.federated import FLClient
    from repro_torch.models import fl_models as tm
    from repro_torch.optim import make_optimizer

    cfg = tm.FemnistConfig(n_fc=2, fc_width=64)

    def loss_fn(p, b):
        return tm.softmax_cross_entropy(tm.femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = tm.femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": (logits.argmax(-1) == b[1]).float().mean() * n,
                "loss_sum": tm.softmax_cross_entropy(logits, b[1]) * n}

    opt = make_optimizer("sgdm", FEMNIST_LR)
    clients = [FLClient(s.client_id, s, loss_fn, opt, batch_size=16, eval_fn=eval_fn,
                        device="cpu")
               for s in make_classification_silos(3, 62, (28, 28, 1), FEMNIST_SAMPLES, seed=0)]
    server = ta.AsyncFLServer(
        clients, params_from_numpy(params0, device="cpu"),
        schedule=ta.DeterministicSchedule(FEMNIST_DELAYS), fold_cost_s=0.01,
        round_deadline=ta.FixedDeadline(t_round_s=3.0), compression=codec,
        measure_round_messages=True, device="cpu")
    return server, server.run(FEMNIST_ROUNDS)


@pytest.fixture(scope="module", params=["int8", "fp16", "topk"])
def femnist_runs(request):
    """Both packages from the reference's initial weights, SGD with
    momentum at lr 1e-3.  The two frameworks' gradients differ at
    rounding level (~1e-6 relative); a codec can turn that into a one-step
    difference in an int8 code (one scale, ~1e-6 here) or a different
    top-k pick near the k-th magnitude (that element's delta, ~1e-5 at
    this learning rate, carried by error feedback).  So params are held
    to 1e-4 and losses to 1e-4."""
    from repro.models import fl_models as jm

    params0 = jm.init_femnist_cnn(jax.random.PRNGKey(0), jm.FemnistConfig(n_fc=2, fc_width=64))
    jserver, jres = _femnist_jax(request.param, params0)
    tserver, tres = _femnist_port(request.param, jax.tree.map(np.asarray, params0))
    return request.param, jserver, jres, tserver, tres


def test_femnist_traces_equal(femnist_runs):
    codec, jserver, _, tserver, _ = femnist_runs
    got, want = _server_trace(tserver.bus), _server_trace(jserver.bus)
    assert got == want
    names = [n for n, _ in got]
    assert names.count("DeadlineExpired") == FEMNIST_ROUNDS and "StragglerEscalated" in names


def test_femnist_message_logs_equal(femnist_runs):
    codec, _, jres, _, tres = femnist_runs
    for t, j in zip(tres.rounds, jres.rounds):
        assert dataclasses.asdict(t.message_log) == dataclasses.asdict(j.message_log)
        assert t.message_log.codec == codec
        assert t.message_log.compression_ratio == j.message_log.compression_ratio
        floor = {"int8": 3.9, "fp16": 1.99, "topk": 6.0}[codec]
        assert t.message_log.compression_ratio > floor


def test_femnist_params_and_losses_agree(femnist_runs):
    _, jserver, jres, tserver, tres = femnist_runs
    _assert_same_tree(tres.final_params, jres.final_params, atol=PARAM_TOL)
    for t, j in zip(tres.rounds, jres.rounds):
        assert abs(t.metrics["loss"] - j.metrics["loss"]) < 1e-4
        assert (t.carried_over, t.carried_in) == (j.carried_over, j.carried_in)
    assert tres.rounds[0].carried_over == ["client_2"]
    assert tres.rounds[1].carried_in == ["client_2"]
    assert tserver.agg_engine.stats.total_wire_bytes == jserver.agg_engine.stats.total_wire_bytes
    assert tserver.agg_engine.stats.total_folded_bytes == \
        jserver.agg_engine.stats.total_folded_bytes


def test_async_server_prefers_the_client_owned_compressor():
    """A client constructed with compression= keeps its own error-feedback
    residual; the server holds one only for clients without."""
    from repro_torch.federated.compression import ClientCompressor

    results = make_results(2)
    tres = _port_results(results)
    clients = [_Stub(r, EvalResult) for r in tres]
    clients[0].compressor = ClientCompressor(CompressionSpec("topk", k_frac=0.5))
    server = ta.AsyncFLServer(clients, tres[0].params, compression="topk:0.5",
                              fold_cost_s=0.1, device="cpu")
    server.run(1)
    assert clients[0].compressor._residual is not None
    assert list(server._compressors) == ["c1"]
    # With a schema as well, each client gets a structured encoder of its own.
    sserver = ta.AsyncFLServer(clients, tres[0].params, schema={"a": "leaf0"},
                               compression="int8", fold_cost_s=0.1, device="cpu")
    sserver.run(1)
    assert sorted(sserver._struct_encoders) == ["c0", "c1"]
