"""The port's checkpoint blobs, files and metrics frames against the
reference's: identical bytes, restorable across packages, and the same
§4.3 handling of corrupt files (mirroring tests/test_checkpoint.py)."""
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ClientCheckpointManager as JaxClientCkpt
from repro.checkpoint import ServerCheckpointManager as JaxServerCkpt
from repro.checkpoint import deserialize_pytree as jax_deserialize
from repro.checkpoint import serialize_pytree as jax_serialize
from repro.federated.messages import serialize_metrics as jax_serialize_metrics
from repro_torch.checkpoint import (
    ClientCheckpointManager,
    DeserializationError,
    ServerCheckpointManager,
    deserialize_pytree,
    pytree_num_bytes,
    resolve_freshest,
    serialize_pytree,
)
from repro_torch.checkpoint._msgpack import MsgpackError, packb, unpackb
from repro_torch.convert import params_from_numpy
from repro_torch.federated.messages import serialize_metrics


def _numpy_tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    vals = lambda shape: rng.standard_normal(shape) * 10  # noqa: E731
    tree = {
        "w": vals((3, 4)),
        "b": vals((4,)),
        "nest": [{"k": vals((2, 2, 2))}, {"k": vals(())}],
        "big": vals((70,)),
    }
    np_dtype = {"float32": np.float32, "int32": np.int32, "float16": np.float16}.get(dtype)
    if np_dtype is not None:
        return {k: _cast(v, np_dtype) for k, v in tree.items()}
    return tree


def _cast(v, dt):
    if isinstance(v, list):
        return [{k: _cast(x, dt) for k, x in d.items()} for d in v]
    return np.asarray(v).astype(dt)


def _both(dtype, seed=0):
    """The same tree for the reference (jnp) and the port (torch)."""
    base = _numpy_tree("float32" if dtype == "bfloat16" else dtype, seed)
    jdt = getattr(jnp, dtype)
    jtree = _map(lambda a: jnp.asarray(a, jdt), base)
    port = params_from_numpy(_map(np.asarray, jtree), device="cpu")
    return jtree, port


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves_equal(torch_tree, jax_tree):
    from repro_torch.utils.tree import tree_leaves
    import jax

    a, b = tree_leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(a) == len(b)
    for t, j in zip(a, b):
        np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), np.asarray(j, np.float32)
                                      if j.dtype == jnp.bfloat16 else np.asarray(j))


# ---------------------------------------------------------------------------
# Blobs and frames: identical bytes
# ---------------------------------------------------------------------------

def _bits_tensor(a):
    """A numpy array of an extension float (fp8) as the same torch tensor."""
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int8).copy()).view(getattr(torch, a.dtype.name))


def _layout_case(case):
    """(reference tree, port tree) whose blob exercises one corner of the
    layout: int64 or bool leaves, a non-contiguous leaf, 0-element and 0-d
    leaves, or headers
    across msgpack's length boundaries (fixstr / str8 / str16 paths, bin8
    / bin16 / bin32 data, uint16 / uint32 shape entries, an array16 of
    more than 15 entries)."""
    rng = np.random.default_rng(7)
    if case == "transposed":
        a = rng.standard_normal((5, 3)).astype(np.float32)
        base = torch.from_numpy(a)
        return ({"w": jnp.asarray(a.T), "v": jnp.asarray(a[::2, 1:])},
                {"w": base.t(), "v": base[::2, 1:]})
    if case == "empty":
        shapes = {"a": (0, 3), "b": (4, 0), "c": (0,)}
        return ({k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()},
                {k: torch.zeros(s) for k, s in shapes.items()})
    if case == "scalar":
        return ({"s": jnp.asarray(2.5, jnp.float32), "i": [jnp.asarray(-7, jnp.int32)]},
                {"s": torch.tensor(2.5), "i": [torch.tensor(-7, dtype=torch.int32)]})
    if case in ("int64", "bool"):
        # Kept as numpy leaves for the reference: jnp would narrow int64.
        a = rng.integers(-2**40, 2**40, (3, 5), dtype=np.int64)
        arrays = {"x": a, "y": [a[0], np.asarray(a[1, 1])]}
        if case == "bool":
            arrays = _map(lambda v: np.asarray(v > 0), arrays)
        return arrays, _map(torch.from_numpy, arrays)
    assert case == "long-headers"
    tree = {"a" * 31: 255, "b" * 32: 256, "c" * 255: 65535, "d" * 256: 65536}
    tree.update({f"e{i:02d}": 1 + i for i in range(14)})
    arrays = {k: rng.integers(0, 256, n, dtype=np.uint8) for k, n in tree.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.mark.parametrize("case", ["float32", "int32", "float16", "bfloat16",
                                  "float8_e4m3fn", "float8_e5m2", "int64", "bool",
                                  "transposed", "empty", "scalar", "long-headers"])
def test_blob_bytes_identical(case):
    if case.startswith("float8"):
        jtree = _map(lambda a: jnp.asarray(a, getattr(jnp, case)),
                     _numpy_tree("float32"))
        port = _map(_bits_tensor, jtree)
    elif case in ("float32", "int32", "float16", "bfloat16"):
        jtree, port = _both(case)
    else:
        jtree, port = _layout_case(case)
    assert serialize_pytree(port) == jax_serialize(jtree)


@pytest.mark.parametrize("metrics", [
    {"loss": 1.25, "acc": 0.5},
    {"acc": 0.1, "loss": 3.0, "nll": 2.0, "a_long_metric_name_of_more_than_31_chars": 7.0},
    {},
])
def test_metrics_frame_bytes_identical(metrics):
    assert serialize_metrics(metrics) == jax_serialize_metrics(metrics)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_blob_restores_across_packages(dtype):
    jtree, port = _both(dtype, seed=1)
    _, like_port = _both(dtype, seed=2)
    restored_port = deserialize_pytree(jax_serialize(jtree), like_port)
    _leaves_equal(restored_port, jtree)
    restored_jax = jax_deserialize(serialize_pytree(port), _both(dtype, seed=3)[0])
    _leaves_equal(port, restored_jax)
    assert pytree_num_bytes(port) == sum(np.asarray(x).nbytes for x in
                                         __import__("jax").tree.leaves(jtree))


def test_restore_keeps_like_device_and_dtype():
    _, port = _both("float32")
    like = _map(lambda t: t.to(torch.float64), port)
    out = deserialize_pytree(serialize_pytree(port), like)
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"


def test_checkpoint_files_restore_across_packages(tmp_path):
    jtree, port = _both("float32", seed=4)
    _, like = _both("float32", seed=5)
    # reference writes, port restores
    JaxClientCkpt(str(tmp_path / "jc")).save(3, jtree)
    r, restored = ClientCheckpointManager(str(tmp_path / "jc")).restore(like)
    assert r == 3
    _leaves_equal(restored, jtree)
    # port writes, reference restores
    ServerCheckpointManager(str(tmp_path / "pl"), str(tmp_path / "pr"),
                            interval_rounds=1).save(5, port, blocking_transfer=True)
    jmgr = JaxServerCkpt(str(tmp_path / "pl"), str(tmp_path / "pr"), interval_rounds=1)
    r, jrestored = jmgr.restore(_both("float32", seed=6)[0])
    assert r == 5
    _leaves_equal(port, jrestored)
    # and the files themselves are identical
    ClientCheckpointManager(str(tmp_path / "pc")).save(3, _both("float32", seed=4)[1])
    assert (tmp_path / "pc" / "round_3.ckpt").read_bytes() == \
        (tmp_path / "jc" / "round_3.ckpt").read_bytes()


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------

_OBJECTS = [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -1.5, 1e300, True, False, None,
    "", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536, "päth/ü",
    b"", b"\0" * 255, b"\0" * 256, b"\0" * 65536,
    [], [1] * 15, [1] * 16, [[1, [2]], {"a": 1}],
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
]


@pytest.mark.parametrize("i", range(len(_OBJECTS)))
def test_msgpack_subset_matches_library(i):
    obj = _OBJECTS[i]
    packed = packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    back = unpackb(packed)
    if isinstance(back, memoryview):
        back = bytes(back)
    assert back == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("blob", [b"", b"\x92\x01", b"\x01\x02", b"\xc1", b"\xd9\x05ab"])
def test_msgpack_rejects_malformed(blob):
    with pytest.raises(MsgpackError):
        unpackb(blob)


# ---------------------------------------------------------------------------
# Template mismatches and corruption (tests/test_checkpoint.py, ported)
# ---------------------------------------------------------------------------

def _state(val):
    return {"w": torch.full((4, 4), val, dtype=torch.float32)}


def _truncate(path, keep_frac=0.5):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))


def test_shape_mismatch_raises():
    blob = serialize_pytree({"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        deserialize_pytree(blob, {"w": torch.zeros((3, 2))})


def test_missing_leaf_raises():
    blob = serialize_pytree({"w": torch.zeros(2)})
    with pytest.raises(KeyError):
        deserialize_pytree(blob, {"w": torch.zeros(2), "extra": torch.zeros(1)})


def test_truncated_blob_raises_deserialization_error():
    blob = serialize_pytree(_state(1.0))
    with pytest.raises(DeserializationError, match="malformed checkpoint blob"):
        deserialize_pytree(blob[: len(blob) // 2], _state(0.0))


def test_truncated_newest_falls_back_to_previous(tmp_path):
    mgr = ServerCheckpointManager(
        str(tmp_path / "l"), str(tmp_path / "r"), interval_rounds=1, keep_last=3
    )
    for r in (1, 2, 3):
        mgr.save(r, _state(float(r)), blocking_transfer=True)
    _truncate(str(tmp_path / "r" / "round_3.ckpt"))
    with pytest.warns(RuntimeWarning, match="skipping unreadable checkpoint"):
        r, restored = mgr.restore(_state(0.0))
    assert r == 2
    assert torch.equal(restored["w"], _state(2.0)["w"])


def test_crc_mismatch_detected_and_skipped(tmp_path):
    mgr = ClientCheckpointManager(str(tmp_path / "c0"))
    mgr.save(1, _state(1.0))
    path = mgr.save(2, _state(2.0))
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.warns(RuntimeWarning, match="CRC32 mismatch"):
        r, restored = mgr.restore(_state(0.0))
    assert r == 1
    assert torch.equal(restored["w"], _state(1.0)["w"])


def test_zero_byte_checkpoint_is_skipped_with_warning(tmp_path):
    mgr = ClientCheckpointManager(str(tmp_path / "c0"))
    mgr.save(4, _state(4.0))
    (tmp_path / "c0" / "round_9.ckpt").write_bytes(b"")
    with pytest.warns(RuntimeWarning, match="skipping empty checkpoint file"):
        info = mgr.latest()
    assert info is not None and info.round_idx == 4
    with pytest.warns(RuntimeWarning, match="skipping empty checkpoint file"):
        r, _ = mgr.restore(_state(0.0))
    assert r == 4


def test_resolve_freshest_passes_over_corrupt_newest(tmp_path):
    s = ServerCheckpointManager(str(tmp_path / "l"), str(tmp_path / "r"), interval_rounds=1)
    cs = {"c0": ClientCheckpointManager(str(tmp_path / "c0"))}
    s.save(4, _state(4.0), blocking_transfer=True)
    s.save(6, _state(6.0), blocking_transfer=True)
    cs["c0"].save(5, _state(5.0))
    _truncate(str(tmp_path / "r" / "round_6.ckpt"))
    src, info = resolve_freshest(s, cs)
    assert src == "client:c0" and info.round_idx == 5
    _truncate(str(tmp_path / "c0" / "round_5.ckpt"), keep_frac=0.3)
    src2, info2 = resolve_freshest(s, cs)
    assert src2 == "server" and info2.round_idx == 4


def test_all_checkpoints_corrupt_raises_not_found(tmp_path):
    mgr = ClientCheckpointManager(str(tmp_path / "c0"))
    path = mgr.save(1, _state(1.0))
    _truncate(path)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError, match="no client checkpoint"):
            mgr.restore(_state(0.0))


def test_freshest_rules(tmp_path):
    """Tie prefers the server; a strictly newer client wins; an excluded
    client is skipped; no manager at all resolves to "none"."""
    s = ServerCheckpointManager(str(tmp_path / "l"), str(tmp_path / "r"), interval_rounds=1)
    cs = {"c0": ClientCheckpointManager(str(tmp_path / "c0")),
          "c1": ClientCheckpointManager(str(tmp_path / "c1"))}
    s.save(7, _state(7.0), blocking_transfer=True)
    cs["c0"].save(7, _state(7.5))
    assert resolve_freshest(s, cs)[0] == "server"
    cs["c0"].save(9, _state(9.0))
    cs["c1"].save(8, _state(8.0))
    assert resolve_freshest(s, cs)[0] == "client:c0"
    assert resolve_freshest(s, cs, exclude_client="c0")[0] == "client:c1"
    assert resolve_freshest(None, {}) == ("none", None)
