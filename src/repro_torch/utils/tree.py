"""Path-keyed flatten / unflatten of nested parameter trees.

The JAX package's parameter trees are plain nested dicts and lists, and
every byte layout the system ships depends on the order ``jax.tree``
visits their leaves: the flat ``(L,)`` aggregation buffer, the entry
order of a checkpoint blob, the size of a weight message.  ``jax.tree``
visits dict children in **sorted-key** order (whatever order they were
inserted in) and list / tuple children by index, and treats ``None`` as
an empty subtree.  ``torch.utils._pytree`` keeps insertion order, so the
port walks trees with this module instead.

Path strings follow ``repro.checkpoint.serializer._path_str``: the keys
and indices on the way to a leaf, joined with ``/`` (``"blocks/0/w"``).

A :class:`TreeDef` is hashable and compares by structure, so it serves
as a cache key; its ``repr`` is the one JAX gives its ``PyTreeDef``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

Path = Tuple[Any, ...]

_DICT, _LIST, _TUPLE, _NONE, _LEAF = "dict", "list", "tuple", "none", "leaf"


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    __slots__ = ("kind", "keys", "children", "num_leaves", "_hash")

    def __init__(self, kind: str, keys: Tuple[Any, ...] = (),
                 children: Tuple["TreeDef", ...] = ()) -> None:
        self.kind = kind
        self.keys = keys
        self.children = children
        self.num_leaves = 1 if kind == _LEAF else sum(c.num_leaves for c in children)
        self._hash = hash((kind, keys, children))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, TreeDef)
            and self._hash == other._hash
            and self.kind == other.kind
            and self.keys == other.keys
            and self.children == other.children
        )

    def __hash__(self) -> int:
        return self._hash

    def _body(self) -> str:
        if self.kind == _LEAF:
            return "*"
        if self.kind == _NONE:
            return "None"
        if self.kind == _DICT:
            inner = ", ".join(f"{k!r}: {c._body()}" for k, c in zip(self.keys, self.children))
            return "{" + inner + "}"
        inner = ", ".join(c._body() for c in self.children)
        if self.kind == _LIST:
            return "[" + inner + "]"
        return "(" + inner + ("," if len(self.children) == 1 else "") + ")"

    def __repr__(self) -> str:
        return f"PyTreeDef({self._body()})"


def _walk(tree: Any, path: Path, out: List[Tuple[Path, Any]]) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        children = tuple(_walk(tree[k], path + (k,), out) for k in keys)
        return TreeDef(_DICT, keys, children)
    if isinstance(tree, list):
        return TreeDef(_LIST, (), tuple(
            _walk(c, path + (i,), out) for i, c in enumerate(tree)))
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return TreeDef(_TUPLE, (), tuple(
            _walk(c, path + (i,), out) for i, c in enumerate(tree)))
    if tree is None:
        return TreeDef(_NONE)
    out.append((path, tree))
    return TreeDef(_LEAF)


def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[Path, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in ``jax.tree`` leaf order."""
    out: List[Tuple[Path, Any]] = []
    treedef = _walk(tree, (), out)
    return out, treedef


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_structure(tree: Any) -> TreeDef:
    return tree_flatten(tree)[1]


def _build(td: TreeDef, it: Iterator[Any]) -> Any:
    if td.kind == _LEAF:
        return next(it)
    if td.kind == _NONE:
        return None
    children = [_build(c, it) for c in td.children]
    if td.kind == _DICT:
        return dict(zip(td.keys, children))
    return children if td.kind == _LIST else tuple(children)


def tree_unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    """Rebuild a tree of ``treedef``'s structure from leaves in flatten
    order (dicts come back in sorted-key order, as from ``jax.tree``).
    ``_build`` is a module function and not a closure: a recursive
    closure over the leaves' iterator is a reference cycle, which would
    hold every leaf (a model's layer stacks) until the cyclic garbage
    collector ran."""
    if len(leaves) != treedef.num_leaves:
        raise ValueError(
            f"treedef has {treedef.num_leaves} leaves, got {len(leaves)}"
        )
    return _build(treedef, iter(leaves))


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and structurally equal ``rest``."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structure mismatch: {r_def} != {treedef}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def path_str(path: Path) -> str:
    """``"a/0/w"`` — the checkpoint blob's key for a leaf."""
    return "/".join(str(p) for p in path)


def keystr(path: Path) -> str:
    """``"['a'][0]['w']"`` — the reference's ``jax.tree_util.keystr`` of a
    leaf's path (schemas and masked optimizers match against it)."""
    return "".join(f"[{p!r}]" for p in path)
