"""The port's structured updates against the reference's (tests/test_structured.py).

Every case runs on numpy-seeded trees handed to both packages.  Inside
the port the full-coverage structured fold must equal the dense flat /
delta fold bit for bit, as it does inside the reference; across the
packages the folds agree within the fp32 kernel tolerance (2e-5), and
schema signatures, structured wire frames and per-group byte counts are
equal exactly (frames byte for byte, in both directions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import agg_engine as jagg
from repro.federated import compression as jcomp
from repro.federated.messages import measure_messages as jax_measure
from repro_torch.checkpoint.serializer import DeserializationError
from repro_torch.convert import params_from_numpy
from repro_torch.federated.agg_engine import (
    AggregationEngine,
    CarryEntry,
    CarryOverBuffer,
    StructureMismatchError,
    UpdateSchema,
    as_update_schema,
    group_plan_for,
    plan_for,
)
from repro_torch.federated.compression import (
    ClientCompressor,
    StructuredCompressor,
    deserialize_structured,
    materialize_structured,
    parse_compression,
    serialize_structured,
)
from repro_torch.federated.messages import measure_messages
from repro_torch.utils.tree import tree_flatten


def _np_tree(seed=0, shapes=((3, 5), (7,), (2, 2))):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}


def _tree(seed=0, shapes=((3, 5), (7,), (2, 2))):
    return params_from_numpy(_np_tree(seed, shapes), device="cpu")


def _jtree(seed=0, shapes=((3, 5), (7,), (2, 2))):
    return jax.tree.map(jnp.asarray, _np_tree(seed, shapes))


def _assert_bit_identical(got, want):
    a_leaves, b_leaves = tree_flatten(got)[0], tree_flatten(want)[0]
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), f"max diff {(a.float() - b.float()).abs().max()}"
        # the sign of a zero too
        assert torch.equal(torch.signbit(a), torch.signbit(b))


def _assert_close_to_jax(got, want, atol=2e-5):
    leaves = tree_flatten(got)[0]
    jleaves = jax.tree.leaves(want)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=atol, rtol=atol)


# ---------------------------------------------------------------------------
# Schema resolution: selector forms, errors, plan cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [
    {"g": "leaf1"},
    {"g": ["leaf1"]},
    {"g": "lambda"},
    {"g": "mask"},
    {"a": "leaf0", "rest": ["leaf1", "leaf2"]},
    {"all": "", "head": "leaf2"},
])
def test_schema_selector_forms_match_reference(groups):
    """All four selector forms resolve to the reference's leaves, group
    plans, coverage predicates and signature."""
    def build():
        out = {}
        for k, v in groups.items():
            if v == "lambda":
                out[k] = lambda p: "leaf1" in p
            elif v == "mask":
                out[k] = {n: n == "leaf1" for n in ("leaf0", "leaf1", "leaf2")}
            else:
                out[k] = v
        return out

    got = UpdateSchema(build()).resolve(_tree())
    want = jagg.UpdateSchema(build()).resolve(_jtree())
    assert got.signature == want.signature
    assert got.leaf_groups == want.leaf_groups
    assert (got.full_coverage, got.covered, got.disjoint) == \
        (want.full_coverage, want.covered, want.disjoint)
    for (n, gp), (jn, jgp) in zip(got.groups, want.groups):
        assert n == jn
        assert (gp.leaf_indices, gp.sizes, gp.total_elems, gp.padded_len, gp.signature) == \
            (jgp.leaf_indices, jgp.sizes, jgp.total_elems, jgp.padded_len, jgp.signature)
        np.testing.assert_array_equal(gp.offsets, jgp.offsets)
        np.testing.assert_array_equal(gp.flatten(_tree(3)).numpy(),
                                      np.asarray(jgp.flatten(_jtree(3))))


@pytest.mark.parametrize("bad,match", [
    (lambda: UpdateSchema({"g": "nonexistent"}).resolve(_tree()), "selects no leaves"),
    (lambda: UpdateSchema({}), "at least one group"),
    (lambda: UpdateSchema([("g", "leaf0"), ("g", "leaf1")]), "duplicate group names"),
    (lambda: UpdateSchema({"g": None}), "no selector"),
    (lambda: as_update_schema(42), "schema must be"),
    (lambda: UpdateSchema({"g": {"leaf0": True}}).resolve(_tree()), "boolean mask has 1"),
    (lambda: group_plan_for(_tree(), ()), "at least one leaf"),
    (lambda: group_plan_for(_tree(), (0, 0)), "duplicate leaf indices"),
    (lambda: group_plan_for(_tree(), (3,)), "out of range"),
])
def test_schema_rejects_like_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        bad()


def test_as_update_schema_passes_through():
    assert as_update_schema(None) is None
    sch = UpdateSchema({"g": "leaf0"})
    assert as_update_schema(sch) is sch
    assert as_update_schema({"g": "leaf0"}).group_names == ("g",)


def test_plan_cache_distinguishes_partitions_of_one_structure():
    """Two partitions of one structure get distinct plans and signatures;
    re-resolving a partition (even of another tree of the same structure)
    hits the cache; full and group plans never collide."""
    tree = _tree()
    p01 = group_plan_for(tree, (0, 1))
    p12 = group_plan_for(tree, (1, 2))
    assert p01 is not p12 and p01.signature != p12.signature
    assert group_plan_for(tree, (0, 1)) is p01
    assert group_plan_for(_tree(seed=9), (1, 0)) is p01
    assert plan_for(tree).signature != p01.signature
    s1 = UpdateSchema({"a": "leaf0", "b": ["leaf1", "leaf2"]}).resolve(tree)
    s2 = UpdateSchema({"a": ["leaf0", "leaf1"], "b": "leaf2"}).resolve(tree)
    assert s1.signature != s2.signature
    assert s1.group("a").signature != s2.group("a").signature
    assert s1.group("a").signature == jagg.group_plan_for(_jtree(), (0,)).signature


# ---------------------------------------------------------------------------
# Full-coverage bit-for-bit equivalence with the dense path (inside the port)
# ---------------------------------------------------------------------------

def _fold_dense(base, locals_, weights, codec=None):
    agg = AggregationEngine().streaming(base=base, base_round=1)
    spec = parse_compression(codec)
    for p, w in zip(locals_, weights):
        if spec is None:
            agg.add(p, w)
        else:
            agg.add_compressed(ClientCompressor(spec).encode(base, p, base_round=1), w)
    return agg.result()


def _fold_structured(schema, base, locals_, weights, codec=None):
    agg = AggregationEngine().streaming(base=base, base_round=1, schema=schema)
    for p, w in zip(locals_, weights):
        agg.add(StructuredCompressor(schema, codec).encode(base, p, base_round=1), w)
    return agg.result()


@pytest.mark.parametrize("codec", [None, "fp16"])
@pytest.mark.parametrize("schema_groups", [
    {"all": ""},
    {"a": "leaf0", "b": ["leaf1", "leaf2"]},
    {"a": "leaf0", "b": "leaf1", "c": "leaf2"},
])
def test_full_coverage_matches_dense_bit_for_bit(codec, schema_groups):
    base = _tree(seed=1)
    locals_ = [_tree(seed=2 + i) for i in range(3)]
    weights = [10.0, 25.0, 7.0]
    schema = UpdateSchema(schema_groups)
    got = _fold_structured(schema, base, locals_, weights, codec)
    _assert_bit_identical(got, _fold_dense(base, locals_, weights, codec))
    # and the reference's structured fold within the kernel tolerance
    jl = [_jtree(seed=2 + i) for i in range(3)]
    jagg_ = jagg.AggregationEngine().streaming(base=_jtree(1), base_round=1,
                                               schema=jagg.UpdateSchema(schema_groups))
    for p, w in zip(jl, weights):
        jagg_.add(jcomp.StructuredCompressor(jagg.UpdateSchema(schema_groups), codec).encode(
            _jtree(1), p, base_round=1), w)
    _assert_close_to_jax(got, jagg_.result())


@pytest.mark.parametrize("codec", ["int8", "topk:0.5"])
def test_single_group_codecs_match_dense_bit_for_bit(codec):
    """int8 / top-k act on QBLOCK spans of the flat vector, so the single
    full group is the dense path's twin."""
    base = _tree(seed=1)
    locals_ = [_tree(seed=2 + i) for i in range(3)]
    weights = [10.0, 25.0, 7.0]
    got = _fold_structured(UpdateSchema({"all": ""}), base, locals_, weights, codec)
    _assert_bit_identical(got, _fold_dense(base, locals_, weights, codec))


@pytest.mark.parametrize("shapes,assignment,weights,codec,seed", [
    (((3,), (2, 2)), (0, 0), [5.0], None, 11),
    (((4, 5), (3,), (1,), (2, 3)), (1, 0, 2, 1), [3.0, 17.0, 40.0], "fp16", 12),
    (((5,), (5, 2), (1, 1)), (0, 1, 0), [1.0, 1.0, 1.0, 50.0], None, 13),
    (((2, 2),), (0,), [9.0, 4.0], "fp16", 14),
])
def test_full_coverage_partitions_match_dense(shapes, assignment, weights, codec, seed):
    """Deterministic twins of the reference's hypothesis property: random
    partitions, weights and codecs, the structured fold bit for bit the
    dense one."""
    base = _tree(seed, shapes)
    locals_ = [_tree(seed + 100 + i, shapes) for i in range(len(weights))]
    groups = {}
    for leaf_idx, g in enumerate(assignment):
        groups.setdefault(f"g{g}", []).append(f"leaf{leaf_idx}")
    got = _fold_structured(UpdateSchema(groups), base, locals_, weights, codec)
    _assert_bit_identical(got, _fold_dense(base, locals_, weights, codec))


def test_full_coverage_carry_over_matches_dense():
    """A parked entry drained with the age discount folds bit for bit as
    on the dense path."""
    base = _tree(seed=1)
    fresh, stale = _tree(seed=2), _tree(seed=3)
    schema = UpdateSchema({"a": "leaf0", "b": ["leaf1", "leaf2"]})

    def run(structured):
        buf = CarryOverBuffer()
        buf.defer(CarryEntry("late", stale, 20.0, origin_round=1))
        agg = AggregationEngine().streaming(base=base, base_round=2,
                                            schema=schema if structured else None)
        folded = agg.fold_carry(buf, round_idx=2, discount=0.5)
        assert [(e.client_id, w) for e, w in folded] == [("late", 10.0)]
        agg.add(fresh, 30.0)
        return agg.result()

    _assert_bit_identical(run(True), run(False))


def test_signed_zero_survives_the_structured_fold():
    """A zero delta on a -0.0 base element: the dense fold keeps -0.0, and
    so must the structured one (its numerator starts at -0.0)."""
    base = {"w": torch.tensor([-0.0, 0.0, 1.0])}
    local = {"w": torch.tensor([-0.0, 0.0, 2.0])}
    got = _fold_structured(UpdateSchema({"all": ""}), base, [local], [3.0])
    _assert_bit_identical(got, _fold_dense(base, [local], [3.0]))


def test_structured_partial_sums_raise_naming_the_hierarchy():
    """Structured partial sums, ported with the hierarchy: the export
    omits groups no client shipped and carries each present group's
    accumulator, weight and count as the reference's does; what still
    raises (an empty export, a partial taken under another schema, named
    by its region) raises as in the reference, with the same message."""
    schema = {"a": "leaf0", "b": "leaf1", "c": "leaf2"}
    raised = []
    for eng, base, local in ((AggregationEngine, _tree(1), _tree(2)),
                             (jagg.AggregationEngine, _jtree(1), _jtree(2))):
        agg = eng().streaming(base=base, base_round=1, schema=schema)
        with pytest.raises(ValueError, match="no clients") as info:
            agg.export_partial()
        raised.append(str(info.value))
        agg.add({"a": agg.schema.group("a").flatten(local)}, 3.0)
        agg.add(local, 5.0)
        raised.append(agg.export_partial(region_id="east"))
        other = eng().streaming(base=base, base_round=1, schema={"all": ""})
        with pytest.raises(StructureMismatchError if eng is AggregationEngine
                           else jagg.StructureMismatchError, match="east") as info:
            other.fold_partial(raised[-1])
        raised.append(str(info.value))
    tmsg, tpart, tmis, jmsg, jpart, jmis = raised
    assert tmsg == jmsg and tmis == jmis
    assert [(n, p.n_clients, p.wsum, p.plan_signature, p.wire_bytes) for n, p in tpart.groups] \
        == [(n, p.n_clients, p.wsum, p.plan_signature, p.wire_bytes) for n, p in jpart.groups]
    assert [n for n, _ in tpart.groups] == ["a", "b", "c"] and tpart.n_clients == 2
    assert tpart.group_wsums() == {"a": 8.0, "b": 5.0, "c": 5.0} == jpart.group_wsums()
    assert tpart.wsum == jpart.wsum == 8.0
    for (_, p), (_, jp) in zip(tpart.groups, jpart.groups):
        np.testing.assert_allclose(p.acc.numpy(), np.asarray(jp.acc), atol=2e-5, rtol=2e-5)
    only_a = AggregationEngine().streaming(base=_tree(1), base_round=1, schema=schema)
    only_a.add({"a": only_a.schema.group("a").flatten(_tree(2))}, 3.0)
    assert [n for n, _ in only_a.export_partial().groups] == ["a"]  # absent groups omitted


def test_full_coverage_hierarchy_partial_sum_matches_dense():
    """The regional partial-sum route (tests/test_structured.py:199): two
    structured regional folds exported and folded into a global
    structured aggregator match the same topology on the dense path, bit
    for bit, and the reference's structured route within 2e-5."""
    base = _tree(seed=1)
    locals_ = [_tree(seed=2 + i) for i in range(4)]
    weights = [10.0, 25.0, 7.0, 13.0]
    regions = [(0, 1), (2, 3)]
    engine = AggregationEngine()
    groups = {"a": "leaf0", "b": ["leaf1", "leaf2"]}
    schema = UpdateSchema(groups)

    def route(eng, schema, base, locals_):
        top = eng.streaming(base=base, base_round=1, schema=schema)
        for ids in regions:
            reg = eng.streaming(base=base, base_round=1, schema=schema)
            for i in ids:
                reg.add(locals_[i], weights[i])
            top.fold_partial(reg.export_partial(region_id=f"r{ids}"))
        return top.result()

    want = route(engine, None, base, locals_)
    got = route(engine, schema, base, locals_)
    _assert_bit_identical(got, want)
    jgot = route(jagg.AggregationEngine(), jagg.UpdateSchema(groups), _jtree(1),
                 [_jtree(seed=2 + i) for i in range(4)])
    _assert_close_to_jax(got, jgot)


# ---------------------------------------------------------------------------
# Partial coverage / overlap: the weight rules
# ---------------------------------------------------------------------------

def test_absent_group_keeps_base_and_contributes_no_weight():
    base = _tree(seed=1)
    local = _tree(seed=2)
    schema = UpdateSchema({"a": "leaf0", "b": "leaf1", "c": "leaf2"})
    resolved = schema.resolve(base)
    agg = AggregationEngine().streaming(base=base, base_round=1, schema=schema)
    agg.add({"a": resolved.group("a").flatten(local).numpy()}, 10.0)
    assert agg.group_wsums() == {"a": 10.0, "b": 0.0, "c": 0.0}
    assert agg.group_counts() == {"a": 1, "b": 0, "c": 0}
    out = agg.result()
    np.testing.assert_allclose(out["leaf0"].numpy(), local["leaf0"].numpy(), rtol=1e-6)
    assert out["leaf1"] is base["leaf1"] and out["leaf2"] is base["leaf2"]
    jbase = _jtree(1)
    jres = jagg.UpdateSchema({"a": "leaf0", "b": "leaf1", "c": "leaf2"}).resolve(jbase)
    jagg_ = jagg.AggregationEngine().streaming(base=jbase, base_round=1,
                                               schema={"a": "leaf0", "b": "leaf1", "c": "leaf2"})
    jagg_.add({"a": np.asarray(jres.group("a").flatten(_jtree(2)))}, 10.0)
    _assert_close_to_jax(out, jagg_.result())


def test_overlapping_groups_normalize_by_covering_weight_sum():
    base = {"x": torch.zeros(4)}
    agg = AggregationEngine().streaming(base=base, base_round=1,
                                        schema={"g1": "x", "g2": "x"})
    agg.add({"g1": torch.full((4,), 2.0)}, 3.0)
    agg.add({"g2": np.full(4, 8.0, np.float32)}, 1.0)
    # numerator 3 * 2 + 1 * 8 = 14 over 3 + 1
    np.testing.assert_allclose(agg.result()["x"].numpy(), np.full(4, 3.5), rtol=1e-6)


def test_structured_rejects_wrong_schema_group_and_base_round():
    base = _tree(seed=1)
    local = _tree(seed=2)
    schema = UpdateSchema({"a": "leaf0"})
    agg = AggregationEngine().streaming(base=base, base_round=1, schema=schema)
    wrong = StructuredCompressor(UpdateSchema({"z": "leaf1"}), None).encode(base, local)
    with pytest.raises(ValueError, match="encoded under schema"):
        agg.add(wrong, 1.0)
    with pytest.raises(StructureMismatchError):
        agg.add({"nope": np.zeros(15, np.float32)}, 1.0)
    good = StructuredCompressor(schema, None).encode(base, local)
    bogus = dataclasses.replace(good, groups=tuple(("nope", p) for _, p in good.groups))
    with pytest.raises(ValueError, match="unknown group"):
        agg.add(bogus, 1.0)
    stale = StructuredCompressor(schema, "int8").encode(base, local, base_round=7)
    with pytest.raises(ValueError, match="base round"):
        agg.add(stale, 1.0)
    with pytest.raises(ValueError, match="elements; the group has"):
        agg.add({"a": np.zeros(3, np.float32)}, 1.0)
    with pytest.raises(ValueError, match="non-negative"):
        agg.add(good, -1.0)
    with pytest.raises(ValueError, match="needs base"):
        AggregationEngine().streaming(schema=schema)
    agg.add(good, 1.0)
    with pytest.raises(ValueError, match="mid-fold"):
        agg.rebase(base, base_round=2)


def test_rebase_reanchors_the_structured_fold():
    schema = UpdateSchema({"a": "leaf0"})
    agg = AggregationEngine().streaming(base=_tree(1), base_round=1, schema=schema)
    agg.add(_tree(2), 1.0)
    agg.result()
    agg.rebase(_tree(5), base_round=2)
    upd = StructuredCompressor(schema, "fp16").encode(_tree(5), _tree(6), base_round=2)
    agg.add(upd, 2.0)
    np.testing.assert_allclose(agg.result()["leaf0"].numpy(), _tree(6)["leaf0"].numpy(),
                               atol=1e-3)
    with pytest.raises(StructureMismatchError):
        agg.rebase(_tree(1, shapes=((2, 5), (7,), (2, 2))))


# ---------------------------------------------------------------------------
# Wire frames: byte-identical across packages, typed errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", [None, "fp16", "int8", "topk:0.5"])
def test_structured_frames_are_byte_identical_across_packages(codec):
    groups = {"a": "leaf0", "b": ["leaf1", "leaf2"]}
    upd = StructuredCompressor(groups, codec).encode(_tree(1), _tree(2), base_round=3)
    jupd = jcomp.StructuredCompressor(groups, codec).encode(_jtree(1), _jtree(2), base_round=3)
    frame, jframe = serialize_structured(upd), jcomp.serialize_structured(jupd)
    assert frame == jframe
    assert upd.wire_bytes == jupd.wire_bytes and upd.dense_bytes == jupd.dense_bytes
    assert upd.group_wire_bytes() == jupd.group_wire_bytes()
    assert upd.group_dense_bytes() == jupd.group_dense_bytes() == {"a": 60, "b": 44}
    # both directions: each package decodes the other's frame to the same bytes
    assert serialize_structured(deserialize_structured(jframe)) == jframe
    assert jcomp.serialize_structured(jcomp.deserialize_structured(frame)) == frame


@pytest.mark.parametrize("codec", [None, "fp16", "int8"])
def test_structured_wire_roundtrip_folds_like_the_original(codec):
    base, local = _tree(1), _tree(2)
    schema = UpdateSchema({"a": "leaf0", "b": ["leaf1", "leaf2"]})
    update = StructuredCompressor(schema, codec).encode(base, local, base_round=3)
    back = deserialize_structured(serialize_structured(update))
    assert back.schema_signature == update.schema_signature
    assert back.base_round == (3 if codec is not None else None)
    assert back.group_names() == ("a", "b")
    aggs = [AggregationEngine().streaming(base=base, base_round=3, schema=schema)
            for _ in range(2)]
    aggs[0].add(update, 5.0)
    aggs[1].add(back, 5.0)
    _assert_bit_identical(aggs[1].result(), aggs[0].result())


def _frame(**over):
    obj = {"v": 1, "structured": 1, "sig": "abc",
           "groups": [["a", {"raw": b"\x00" * 8, "n": 2}]]}
    obj.update(over)
    from repro_torch.checkpoint._msgpack import packb

    return packb({k: v for k, v in obj.items() if v is not None})


@pytest.mark.parametrize("frame,match", [
    (b"\xc1", "malformed"),
    (_frame(structured=None), "not a structured"),
    (_frame(v=2), "version"),
    (_frame(sig=""), "schema tag"),
    (_frame(br="x"), "base round"),
    (_frame(groups=[]), "no groups"),
    (_frame(groups=[["a"]]), "not \\[name, payload\\]"),
    (_frame(groups=[["a", {"raw": "str", "n": 1}]]), "not bytes"),
    (_frame(groups=[["a", {"raw": b"\x00" * 7, "n": 2}]]), "raw payload length"),
    (_frame(groups=[["a", {"v": 1, "codec": "int9", "n": 2, "data": b"\x00\x00"}]]),
     "unknown codec"),
])
def test_bad_structured_frames_raise_typed_errors_in_both(frame, match):
    with pytest.raises(DeserializationError, match=match):
        deserialize_structured(frame)
    from repro.checkpoint.serializer import DeserializationError as JaxDeserializationError

    with pytest.raises(JaxDeserializationError):
        jcomp.deserialize_structured(frame)


@pytest.mark.parametrize("codec", [None, "fp16"])
def test_materialize_structured_pins_group_values(codec):
    base, local = _tree(1), _tree(2)
    schema = UpdateSchema({"a": "leaf0"})
    resolved = schema.resolve(base)
    update = StructuredCompressor(schema, codec).encode(base, local)
    pinned = materialize_structured(base, update, resolved)
    assert set(pinned) == {"a"}
    want = resolved.group("a").flatten(local).numpy()
    jpinned = jcomp.materialize_structured(
        _jtree(1), jcomp.StructuredCompressor({"a": "leaf0"}, codec).encode(_jtree(1), _jtree(2)),
        jagg.UpdateSchema({"a": "leaf0"}).resolve(_jtree(1)))
    np.testing.assert_array_equal(pinned["a"].numpy(), jpinned["a"])
    if codec is None:
        np.testing.assert_array_equal(pinned["a"].numpy(), want)
    else:
        np.testing.assert_allclose(pinned["a"].numpy(), want, rtol=1e-3, atol=1e-3)
    aggs = [AggregationEngine().streaming(base=base, schema=schema) for _ in range(2)]
    aggs[0].add(update, 5.0)
    aggs[1].add(pinned, 5.0)
    _assert_bit_identical(aggs[1].result(), aggs[0].result())
    with pytest.raises(ValueError, match="encoded under schema"):
        materialize_structured(base, update, UpdateSchema({"b": "leaf1"}))


def test_structured_error_feedback_matches_reference_over_rounds():
    """Per-group residuals: three rounds of int8 encodes give the
    reference's frames byte for byte."""
    groups = {"a": "leaf0", "b": ["leaf1", "leaf2"]}
    enc, jenc = StructuredCompressor(groups, "int8"), jcomp.StructuredCompressor(groups, "int8")
    for r in range(3):
        f = serialize_structured(enc.encode(_tree(r), _tree(10 + r), base_round=r))
        jf = jcomp.serialize_structured(jenc.encode(_jtree(r), _jtree(10 + r), base_round=r))
        assert f == jf
    assert set(enc._residuals) == {"a", "b"}
    enc.reset()
    assert enc._residuals == {}
    with pytest.raises(ValueError, match="needs a schema"):
        StructuredCompressor(None)


# ---------------------------------------------------------------------------
# Message accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", [None, "int8", "fp16", "topk:0.25"])
def test_measure_messages_structured_matches_reference(codec):
    log = measure_messages(_tree(), {"loss": 1.0}, compression=codec, schema={"a": "leaf0"})
    jlog = jax_measure(_jtree(), {"loss": 1.0}, compression=codec, schema={"a": "leaf0"})
    assert dataclasses.asdict(log) == dataclasses.asdict(jlog)
    assert log.codec == ("structured" if codec is None else f"structured:{codec.split(':')[0]}")
    assert log.group_dense_bytes == {"a": 15 * 4}
    assert log.c_msg_train_dense_bytes == plan_for(_tree()).total_elems * 4
    assert log.compression_ratio == jlog.compression_ratio


# ---------------------------------------------------------------------------
# The async round engine with a schema: carry-over parks structured updates
# as per-group values, drift-aware discounts measure them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec,drift", [(None, False), ("int8", False), ("fp16", True)])
def test_structured_carry_over_in_the_engine_matches_reference(codec, drift):
    """Two rounds of the engine under a deadline in both packages: the late
    silo's structured update is materialized against round 1's base, parked,
    and folded into round 2 with its discount; reports, traces and carry
    state equal (fold cost fixed), params within 2e-5."""
    from repro.federated import async_server as ja
    from repro.federated.client import ClientResult as JaxResult
    from repro_torch.federated import async_server as ta
    from repro_torch.federated.agg_engine import DriftAwareDiscount
    from repro_torch.federated.client import ClientResult

    groups = {"a": "leaf0", "b": ["leaf1", "leaf2"]}
    weights = {"c0": 10, "c1": 20, "c2": 30}
    delays = {"c0": 1.0, "c1": 1.5, "c2": 5.0}
    kw = dict(fold_cost_s=0.1, schema=groups)
    tengine = ta.AsyncRoundEngine(deadline=ta.FixedDeadline(t_round_s=3.0),
                                  staleness_policy=DriftAwareDiscount() if drift else None, **kw)
    jengine = ja.AsyncRoundEngine(deadline=ja.FixedDeadline(t_round_s=3.0),
                                  staleness_policy=jagg.DriftAwareDiscount() if drift else None,
                                  **kw)
    tbase, jbase = _tree(1), _jtree(1)
    tenc = {c: StructuredCompressor(groups, codec) for c in weights}
    jenc = {c: jcomp.StructuredCompressor(groups, codec) for c in weights}
    for r in (1, 2):
        seeds = {c: 10 * r + i for i, c in enumerate(weights)}
        tres = [ClientResult(c, tenc[c].encode(tbase, _tree(seeds[c]), base_round=r), w, 0.0)
                for c, w in weights.items()]
        jres = [JaxResult(c, jenc[c].encode(jbase, _jtree(seeds[c]), base_round=r), w, 0.0)
                for c, w in weights.items()]
        got = tengine.fold_round(r, tres, ta.DeterministicSchedule(delays), base_params=tbase)
        want = jengine.fold_round(r, jres, ja.DeterministicSchedule(delays), base_params=jbase)
        assert [dataclasses.asdict(e) for e in got.events] == \
            [dataclasses.asdict(e) for e in want.events]
        assert (got.carried_over, got.carried_in) == (want.carried_over, want.carried_in)
        assert tengine.carry.clients() == jengine.carry.clients()
        _assert_close_to_jax(got.params, want.params)
        tbase, jbase = got.params, want.params
    assert got.carried_in == ["c2"]
    assert [(type(e).__name__, dataclasses.asdict(e)) for e in tengine.bus.trace] == \
        [(type(e).__name__, dataclasses.asdict(e)) for e in jengine.bus.trace]
