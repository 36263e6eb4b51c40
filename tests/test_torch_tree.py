"""The port's tree walk visits leaves in jax.tree's order, with the
reference serializer's path strings."""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.serializer import _path_str
from repro_torch.utils.tree import (
    path_str,
    tree_flatten,
    tree_flatten_with_path,
    tree_map,
    tree_unflatten,
)


def _dense_like():
    # Built like fl_models._dense: "w" inserted before "b".
    return {"w": np.zeros((3, 2)), "b": np.zeros(2)}


_TREES = {
    "flat": {"b": 1.0, "a": 2.0, "c": 3.0},
    "dense_w_before_b": {"fc1": _dense_like(), "conv": _dense_like(), "head": _dense_like()},
    "nested_dict_list": {
        "z": [{"w": np.ones(1), "b": np.ones(2)}, {"w": np.ones(3), "b": np.ones(4)}],
        "a": {"y": np.ones(5), "x": [np.ones(6), np.ones(7)]},
        "m": np.ones(8),
    },
    "list_root": [{"k2": 1, "k1": 2}, [3, [4, 5]], 6],
    "tuple_and_none": {"t": (1, 2), "n": None, "e": {}, "l": []},
    "fc_indices": {f"fc{i}": {"w": i, "b": -i} for i in (0, 1, 2, 10, 11)},
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_leaf_order_and_paths_match_jax(name):
    tree = _TREES[name]
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got, _ = tree_flatten_with_path(tree)
    assert [path_str(p) for p, _ in got] == [_path_str(p) for p, _ in want]
    assert [id(leaf) for _, leaf in got] == [id(leaf) for _, leaf in want]


@pytest.mark.parametrize("name", sorted(_TREES))
def test_treedef_repr_matches_jax(name):
    tree = _TREES[name]
    assert repr(tree_flatten(tree)[1]) == repr(jax.tree.structure(tree))


def test_unflatten_roundtrip_and_sorted_dicts():
    tree = _TREES["nested_dict_list"]
    leaves, treedef = tree_flatten(tree)
    back = tree_unflatten(treedef, leaves)
    assert list(back) == ["a", "m", "z"]
    assert tree_flatten(back)[1] == treedef
    doubled = tree_map(lambda a, b: a + b, tree, tree)
    np.testing.assert_array_equal(doubled["a"]["x"][1], 2 * np.ones(7))


def test_unflatten_and_map_free_their_leaves_without_the_cycle_collector():
    """Dropping a rebuilt tree frees its leaves at once: nothing in
    ``tree_unflatten`` (or ``tree_map``, which calls it) keeps the leaf
    list in a reference cycle that only ``gc`` would break.  Such a cycle
    held a served model's layer stacks (30 GB for deepseek-moe-16b) past
    the model's last use."""
    _, treedef = tree_flatten({"a": [0, 0], "b": {"c": 0}})
    gc.disable()
    try:
        leaves = [torch.zeros(4) for _ in range(3)]
        refs = [weakref.ref(t) for t in leaves]
        tree = tree_unflatten(treedef, leaves)
        mapped = tree_map(lambda t: t + 1, tree)
        mapped_refs = [weakref.ref(t) for t in tree_flatten(mapped)[0]]
        del leaves, tree, mapped
        assert all(r() is None for r in refs + mapped_refs)
    finally:
        gc.enable()


def test_unflatten_rejects_wrong_leaf_count():
    _, treedef = tree_flatten({"a": 1, "b": 2})
    with pytest.raises(ValueError):
        tree_unflatten(treedef, [1])


def test_params_numpy_roundtrip_keeps_paths_and_bf16_bits():
    import jax.numpy as jnp
    import torch

    from repro_torch.convert import params_from_numpy, params_to_numpy

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "h": [np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)),
                  np.asarray(jnp.asarray(7, jnp.int32))]}
    port = params_from_numpy(tree, device="cpu")
    assert port["h"][0].dtype == torch.bfloat16 and port["h"][1].shape == ()
    back = params_to_numpy(port)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["h"][0], np.asarray(tree["h"][0], np.float32))
    assert [path_str(p) for p, _ in tree_flatten_with_path(back)[0]] == ["h/0", "h/1", "w"]
