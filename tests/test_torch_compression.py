"""The port's compressed wire path against the reference's.

Both packages get the same numpy-seeded inputs.  What must agree, and how:
- int8 and fp16 frames byte for byte; top-k frames byte for byte on
  tie-free inputs (the magnitudes of a standard normal draw are distinct):
  where several elements tie at the k-th largest magnitude, neither
  ``np.argpartition`` nor ``torch.topk`` fixes which one it keeps.
- Decoding: each package reads the other's frames, and the port raises
  its own ``DeserializationError`` on the reference's bad frames
  (tests/test_compression.py).
- ``dequant_fold``: the port's plain version against the reference's
  Pallas kernel in interpret mode within 1e-5 (the reference's own
  tolerance for its kernel); they compute ``acc + (w*s)*x`` in fp32, but
  XLA may fuse the multiply-add.
- Folds, error feedback and materialized carries within 1e-5 (fp32
  rounding of sums taken in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ragged_trees
from repro.federated import compression as jc
from repro.federated.agg_engine import AggregationEngine as JaxEngine
from repro.federated.agg_engine import plan_for as jax_plan_for
from repro.kernels.fedavg_reduce import dequant_fold as jax_dequant_fold
from repro_torch.checkpoint._msgpack import packb
from repro_torch.checkpoint.serializer import DeserializationError
from repro_torch.convert import params_from_numpy
from repro_torch.federated import compression as tc
from repro_torch.federated.agg_engine import AggregationEngine, plan_for
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant_fold import BLOCK, dequant_fold, dequant_fold_plain

CODECS = ["int8", "fp16", "topk"]
LENGTHS = [1, 100, tc.QBLOCK, 3 * tc.QBLOCK + 17]


def _spec_pair(codec, k_frac=0.1):
    return jc.CompressionSpec(codec, k_frac=k_frac), tc.CompressionSpec(codec, k_frac=k_frac)


def _vec(n, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# Codecs: byte-identical frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("base_round", [None, 3])
def test_frames_byte_identical(codec, n, base_round):
    vec = _vec(n, seed=n)
    jspec, tspec = _spec_pair(codec)
    want = jc.serialize_update(jc.compress(vec, jspec, base_round=base_round))
    got_update = tc.compress(torch.from_numpy(vec), tspec, base_round=base_round)
    assert tc.serialize_update(got_update) == want
    assert got_update.wire_bytes == len(want)
    assert got_update.dense_bytes == 4 * n


def test_int8_zero_blocks_and_extremes_byte_identical():
    """All-zero blocks get scale 0 and codes 0; the block's absmax maps to
    +-127; halves round to even, as np.rint does."""
    vec = np.zeros(3 * tc.QBLOCK + 5, np.float32)
    vec[tc.QBLOCK:2 * tc.QBLOCK] = np.linspace(-1.0, 1.0, tc.QBLOCK, dtype=np.float32)
    vec[-5:] = [0.25, -0.5, 127.0, -127.0, 63.5]
    jspec, tspec = _spec_pair("int8")
    j = jc.compress(vec, jspec)
    t = tc.compress(vec, tspec)
    assert j.scales[0] == 0.0 and t.scales[0].item() == 0.0
    assert tc.serialize_update(t) == jc.serialize_update(j)
    np.testing.assert_array_equal(tc.decompress(t).numpy(), jc.decompress(j))


@pytest.mark.parametrize("codec", CODECS)
def test_decompress_matches_reference(codec):
    vec = _vec(2 * tc.QBLOCK + 100, seed=1)
    jspec, tspec = _spec_pair(codec)
    np.testing.assert_array_equal(tc.decompress(tc.compress(vec, tspec)).numpy(),
                                  jc.decompress(jc.compress(vec, jspec)))


@pytest.mark.parametrize("codec", CODECS)
def test_frames_cross_decode(codec):
    """A frame from either package decodes in the other to the same update."""
    vec = _vec(tc.QBLOCK + 33, seed=2)
    jspec, tspec = _spec_pair(codec)
    jframe = jc.serialize_update(jc.compress(vec, jspec, base_round=7))
    tframe = tc.serialize_update(tc.compress(vec, tspec, base_round=7))
    back_t = tc.deserialize_update(jframe)
    back_j = jc.deserialize_update(tframe)
    assert back_t.base_round == back_j.base_round == 7
    assert back_t.codec == back_j.codec == codec
    np.testing.assert_array_equal(tc.decompress(back_t).numpy(), jc.decompress(back_j))
    assert tc.serialize_update(back_t) == jframe


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", [1, 5000, 4 * tc.QBLOCK, 4 * tc.QBLOCK + 1])
def test_compressed_wire_bytes_match_reference(codec, n):
    jspec, tspec = _spec_pair(codec)
    assert tc.compressed_wire_bytes(n, tspec) == jc.compressed_wire_bytes(n, jspec)


def test_topk_keeps_largest_sorted():
    vec = _vec(5000, seed=3)
    update = tc.compress(vec, tc.CompressionSpec("topk", k_frac=0.1))
    k = tc.topk_count(vec.size, 0.1)
    assert update.indices.numel() == k == update.data.numel()
    assert update.indices.dtype == torch.int32 and update.data.dtype == torch.float16
    assert bool((update.indices[1:] > update.indices[:-1]).all())
    assert set(update.indices.tolist()) == set(np.argsort(-np.abs(vec))[:k].tolist())


@pytest.mark.parametrize("n,k_frac", [(10, 1.0), (3, 0.5), (1000, 0.001)])
def test_topk_count_matches_reference(n, k_frac):
    assert tc.topk_count(n, k_frac) == jc.topk_count(n, k_frac)


# ---------------------------------------------------------------------------
# Bad frames raise the port's typed error (tests/test_compression.py:133-164)
# ---------------------------------------------------------------------------

def _bad_frames():
    frame = jc.serialize_update(jc.compress(_vec(tc.QBLOCK, seed=4), jc.CompressionSpec("int8")))
    cut = [frame[: len(frame) // 2], frame[:-3], b"not msgpack at all", b""]
    ok = {"v": 1, "codec": "int8", "n": 8, "data": b"\x01" * 8,
          "scales": np.ones(1, np.float32).tobytes()}
    objs = [
        {**ok, "v": 2},
        {**ok, "codec": "lz4"},
        {**ok, "n": 0},
        {**ok, "data": b"\x01" * 7},
        {**ok, "scales": b"\x00" * 3},
        {"v": 1, "codec": "topk", "n": 8, "data": b"\x01" * 4,
         "idx": np.array([3, 1], np.int32).tobytes()},
        {"v": 1, "codec": "topk", "n": 8, "data": b"\x01" * 4,
         "idx": np.array([1, 9], np.int32).tobytes()},
        {**ok, "br": "r1"},
        [1, 2, 3],
    ]
    import msgpack

    return cut + [msgpack.packb(o, use_bin_type=True) for o in objs]


@pytest.mark.parametrize("index", range(13))
def test_bad_frames_raise_typed_error(index):
    bad = _bad_frames()[index]
    with pytest.raises(jc.DeserializationError):
        jc.deserialize_update(bad)
    with pytest.raises(DeserializationError):
        tc.deserialize_update(bad)


def test_own_packer_writes_msgpack_bytes():
    import msgpack

    obj = {"v": 1, "codec": "int8", "n": 70000, "data": b"\x00" * 70000, "br": 300}
    assert packb(obj) == msgpack.packb(obj, use_bin_type=True)


# ---------------------------------------------------------------------------
# parse_compression / spec validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", [None, "int8", "fp16", "topk", "topk:0.05", " INT8 "])
def test_parse_compression_matches_reference(knob):
    j, t = jc.parse_compression(knob), tc.parse_compression(knob)
    assert (j is None) == (t is None)
    if t is not None:
        assert (t.codec, t.k_frac, t.error_feedback) == (j.codec, j.k_frac, j.error_feedback)


@pytest.mark.parametrize("knob", ["lz4", "topk:1.5", "int8:0.5", "topk:abc", 123])
def test_parse_compression_rejects_bad_knobs(knob):
    with pytest.raises(ValueError):
        jc.parse_compression(knob)
    with pytest.raises(ValueError):
        tc.parse_compression(knob)


# ---------------------------------------------------------------------------
# dequant_fold: the plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "fp16"])
@pytest.mark.parametrize("n,lp", [(BLOCK, BLOCK), (2 * BLOCK + 123, 3 * BLOCK), (5, BLOCK)])
def test_dequant_fold_matches_pallas(codec, n, lp):
    vec = _vec(n, seed=5)
    cu = jc.compress(vec, jc.CompressionSpec(codec))
    data = np.zeros(lp, dtype=np.asarray(cu.data).dtype)
    data[:n] = cu.data
    scales = (np.asarray(cu.scales, np.float32) if cu.scales is not None
              else np.ones(lp // BLOCK, np.float32))
    if scales.size < lp // BLOCK:
        scales = np.concatenate([scales, np.ones(lp // BLOCK - scales.size, np.float32)])
    acc0 = _vec(lp, seed=6)
    want = np.asarray(jax_dequant_fold(jnp.asarray(acc0), jnp.asarray(data), jnp.asarray(scales),
                                       jnp.float32(2.5), interpret=True))
    # The padded payload (the reference's layout) and the wire-length one.
    for payload in (data, data[:n]):
        acc = torch.from_numpy(acc0.copy())
        out = ops.dequant_fold(acc, torch.from_numpy(payload.copy()), torch.from_numpy(scales),
                               2.5)
        assert out is acc
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(out.numpy()[n:], acc0[n:])


def test_dequant_fold_rejects_unpadded_acc():
    with pytest.raises(ValueError, match="BLOCK"):
        jax_dequant_fold(jnp.zeros(BLOCK + 1, jnp.float32), jnp.zeros(BLOCK + 1, jnp.int8),
                         jnp.ones(1, jnp.float32), jnp.float32(1.0), interpret=True)
    with pytest.raises(ValueError, match="BLOCK"):
        dequant_fold(torch.zeros(BLOCK + 1), torch.zeros(BLOCK + 1, dtype=torch.int8),
                     torch.ones(1), 1.0)


@pytest.mark.parametrize("bad", ["acc_dtype", "data_dtype", "scales", "too_long", "device"])
def test_dequant_fold_rejects_bad_input(bad):
    """Nothing but a CPU tensor reaches the plain version: another device
    raises instead of falling back."""
    acc, data, scales = torch.zeros(BLOCK), torch.zeros(BLOCK, dtype=torch.int8), torch.ones(1)
    if bad == "acc_dtype":
        acc = acc.double()
    elif bad == "data_dtype":
        data = data.float()
    elif bad == "scales":
        scales = torch.ones(2)
    elif bad == "too_long":
        data = torch.zeros(BLOCK + 1, dtype=torch.int8)
    else:
        acc, data, scales = acc.to("meta"), data.to("meta"), scales.to("meta")
    with pytest.raises((TypeError, ValueError)):
        dequant_fold(acc, data, scales, 1.0)


def test_dequant_fold_ref_and_launch_count():
    """ref's oracle is the plain version, and a CPU call launches nothing."""
    acc = torch.from_numpy(_vec(2 * BLOCK, seed=7))
    data = torch.from_numpy((_vec(2 * BLOCK - 9, seed=8) * 1000).astype(np.int8))
    scales = torch.rand(2, generator=torch.Generator().manual_seed(0))
    before = dequant_fold.launches
    a = ref.dequant_fold_ref(acc.clone(), data, scales, 0.3)
    b = dequant_fold(acc.clone(), data, scales, 0.3)
    assert torch.equal(a, b) and torch.equal(a, dequant_fold_plain(acc.clone(), data, scales, 0.3))
    assert dequant_fold.launches == before


# ---------------------------------------------------------------------------
# Fused fold == dense fold of the decompressed updates, and == the
# reference's fold (tests/test_compression.py:238-295)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n_clients", [1, 3])
def test_fused_fold_matches_dense_and_reference(codec, n_clients):
    k_frac = 0.3
    trees, weights = ragged_trees(n_clients, seed=n_clients)
    base = ragged_trees(1, seed=n_clients + 1000)[0][0]
    jplan = jax_plan_for(base)
    jbase = np.asarray(jplan.flatten(base))
    jspec, tspec = _spec_pair(codec, k_frac)

    jagg = JaxEngine(use_pallas=True, interpret=True).streaming(base=base)
    tengine = AggregationEngine()
    tagg = tengine.streaming(base=_port(base))
    dense = np.zeros(jplan.total_elems, np.float64)
    for t, w in zip(trees, weights):
        delta = np.asarray(jplan.flatten(t)) - jbase
        jagg.add(jc.compress(delta, jspec), w)
        update = tc.compress(torch.from_numpy(delta), tspec)
        tagg.add(update, w)
        dense += np.float64(w) * tc.decompress(update).double().numpy()
    want = jagg.result()
    got = tagg.result()
    tplan = plan_for(_port(base))
    got_flat = tplan.flatten(got).numpy()
    np.testing.assert_allclose(got_flat, np.asarray(jplan.flatten(want)), atol=1e-5, rtol=0)
    oracle = jbase + (dense / sum(weights)).astype(np.float32)
    np.testing.assert_allclose(got_flat, oracle, atol=1e-5, rtol=0)
    assert tengine.stats.total_wire_bytes == sum(
        len(jc.serialize_update(jc.compress(np.zeros(jplan.total_elems, np.float32), jspec)))
        for _ in trees)
    assert tengine.stats.total_folded_bytes == 4 * jplan.total_elems * n_clients


def test_compressed_fold_rejects_wrong_base_round_and_length():
    base = {"w": torch.zeros(10)}
    agg = AggregationEngine().streaming(base=base, base_round=2)
    spec = tc.CompressionSpec("fp16")
    with pytest.raises(ValueError, match="base round"):
        agg.add(tc.compress(torch.ones(10), spec, base_round=1), 1.0)
    with pytest.raises(ValueError, match="elements"):
        agg.add(tc.compress(torch.ones(11), spec, base_round=2), 1.0)
    with pytest.raises(ValueError, match="delta base"):
        AggregationEngine().streaming().add(tc.compress(torch.ones(10), spec), 1.0)


# ---------------------------------------------------------------------------
# Error feedback (tests/test_compression.py:311-342) and ClientCompressor
# parity across rounds
# ---------------------------------------------------------------------------

def test_error_feedback_carries_dropped_mass():
    comp = tc.ClientCompressor(tc.CompressionSpec("topk", k_frac=0.5, error_feedback=True))
    base = {"w": torch.zeros(6)}
    local = {"w": torch.tensor([1.0, -2.0, 0.1, 0.2, 3.0, -0.3])}
    comp.encode(base, local)
    resid = comp._residual.numpy()
    np.testing.assert_allclose(np.sort(np.abs(resid[np.abs(resid) > 0])), [0.1, 0.2, 0.3],
                               atol=1e-6)
    shipped = tc.decompress(comp.encode(base, base)).numpy()
    np.testing.assert_allclose(np.sort(np.abs(shipped[np.abs(shipped) > 0])), [0.1, 0.2, 0.3],
                               atol=1e-3)


def test_error_feedback_off_keeps_no_state():
    comp = tc.ClientCompressor(tc.CompressionSpec("topk", k_frac=0.5, error_feedback=False))
    base = {"w": torch.zeros(6)}
    comp.encode(base, {"w": torch.tensor([1.0, -2.0, 0.1, 0.2, 3.0, -0.3])})
    assert comp._residual is None
    assert float(tc.decompress(comp.encode(base, base)).abs().max()) == 0.0


@pytest.mark.parametrize("codec", CODECS)
def test_client_compressor_matches_reference_over_rounds(codec):
    """Three rounds of encode with error feedback: the same frames and the
    same residual in both packages."""
    trees, _ = ragged_trees(4, seed=11)
    jspec, tspec = _spec_pair(codec, 0.2)
    jcomp, tcomp = jc.ClientCompressor(jspec), tc.ClientCompressor(tspec)
    for r in range(3):
        g, p = trees[r], trees[r + 1]
        jframe = jc.serialize_update(jcomp.encode(g, p, base_round=r))
        tframe = tc.serialize_update(tcomp.encode(_port(g), _port(p), base_round=r))
        assert tframe == jframe
        np.testing.assert_allclose(tcomp._residual.numpy(), jcomp._residual, atol=1e-6, rtol=0)
    tcomp.reset()
    assert tcomp._residual is None


def test_client_owned_compressor():
    from repro_torch.federated import FLClient

    client = FLClient("c0", None, None, None, compression="topk:0.5", device="cpu")
    assert client.compressor.spec == tc.CompressionSpec("topk", k_frac=0.5)
    update = client.encode_update({"w": torch.zeros(4)}, {"w": torch.tensor([1.0, 0, 0, 2])})
    assert update.indices.tolist() == [0, 3]
    with pytest.raises(ValueError, match="compressor"):
        FLClient("c1", None, None, None, device="cpu").encode_update({}, {})


@pytest.mark.parametrize("codec", CODECS)
def test_materialize_update_matches_reference(codec):
    trees, _ = ragged_trees(2, seed=12)
    jplan = jax_plan_for(trees[0])
    delta = np.asarray(jplan.flatten(trees[1])) - np.asarray(jplan.flatten(trees[0]))
    jspec, tspec = _spec_pair(codec)
    want = jc.materialize_update(trees[0], jc.compress(delta, jspec))
    got = tc.materialize_update(_port(trees[0]), tc.compress(delta, tspec))
    np.testing.assert_array_equal(plan_for(got).flatten(got).numpy(),
                                  np.asarray(jplan.flatten(want)))
    with pytest.raises(ValueError, match="elements"):
        tc.materialize_update(_port(trees[0]), tc.compress(delta[:-1], tspec))


# ---------------------------------------------------------------------------
# Message accounting and the streaming aggregator's own surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", [None] + CODECS)
def test_measure_messages_matches_reference(codec):
    from repro.federated.messages import measure_messages as jax_measure
    from repro.federated.messages import model_weight_bytes as jax_weight_bytes
    from repro_torch.federated.messages import measure_messages, model_weight_bytes

    tree = ragged_trees(1, seed=13)[0][0]
    metrics = {"loss": 0.5, "acc": 0.25}
    want = jax_measure(tree, metrics, compression=codec)
    got = measure_messages(_port(tree), metrics, compression=codec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.compression_ratio == want.compression_ratio
    assert (got.compression_ratio is None) == (codec is None)
    assert model_weight_bytes(_port(tree)) == jax_weight_bytes(tree)


def test_streaming_surface_matches_reference():
    """Tree mode with stale folds and a drained carry buffer, and flat mode
    reused across rounds through rebase(), in both packages."""
    from repro.federated.agg_engine import CarryEntry as JaxEntry
    from repro.federated.agg_engine import CarryOverBuffer as JaxBuffer
    from repro_torch.federated.agg_engine import CarryEntry, CarryOverBuffer

    trees, weights = ragged_trees(4, seed=14)
    jagg = JaxEngine().streaming()
    tagg = AggregationEngine().streaming()
    jbuf, tbuf = JaxBuffer(), CarryOverBuffer()
    for i in (2, 3):
        jbuf.defer(JaxEntry(f"c{i}", trees[i], weights[i], origin_round=1))
        tbuf.defer(CarryEntry(f"c{i}", _port(trees[i]), weights[i], origin_round=1))
    assert tbuf.pending_weight() == jbuf.pending_weight() and len(tbuf) == 2
    for t, w in zip(trees[:2], weights[:2]):
        jagg.add(t, w)
        tagg.add(_port(t), w)
    assert tagg.add_stale(_port(trees[0]), 3.0, 2, 0.5) == jagg.add_stale(trees[0], 3.0, 2, 0.5)
    jfolded = jagg.fold_carry(jbuf, 3, 0.5)
    tfolded = tagg.fold_carry(tbuf, 3, 0.5)
    assert [w for _, w in tfolded] == [w for _, w in jfolded] and not tbuf
    got, want = tagg.result(), jagg.result()
    np.testing.assert_allclose(plan_for(got).flatten(got).numpy(),
                               np.asarray(jax_plan_for(want).flatten(want)), atol=2e-5)
    assert not tagg.mid_fold

    # Flat mode reused for a second round: rebase, then fold against it.
    agg = AggregationEngine().streaming(base=_port(trees[0]), base_round=1)
    agg.add(_port(trees[1]), 1.0)
    with pytest.raises(ValueError, match="mid-fold"):
        agg.rebase(_port(trees[1]), base_round=2)
    agg.result()
    agg.rebase(_port(trees[1]), base_round=2)
    delta = torch.from_numpy(np.asarray(jax_plan_for(trees[2]).flatten(trees[2]))
                             - np.asarray(jax_plan_for(trees[1]).flatten(trees[1])))
    update = tc.compress(delta, tc.CompressionSpec("fp16"), base_round=2)
    agg.add(update, 2.0)
    out = agg.result()
    want = np.asarray(jax_plan_for(trees[1]).flatten(trees[1])) + tc.decompress(update).numpy()
    np.testing.assert_allclose(plan_for(out).flatten(out).numpy(), want, atol=1e-6)
    from repro_torch.federated.agg_engine import StructureMismatchError

    with pytest.raises(StructureMismatchError):
        agg.rebase({"w": torch.zeros(3)})
    with pytest.raises(StructureMismatchError):
        tagg.add(_port(trees[0]), 1.0)
        tagg.add({"w": torch.zeros(3)}, 1.0, client_id="c9")
