"""Small tree utilities (the reference's ``utils/tree.py``), and the
flatten / unflatten pair the checkpoints need.

A tree is nested dicts, lists, tuples and NamedTuples; anything else is a
leaf (a tensor, a numpy array, a Python int or float). Dict keys are
visited in sorted order and sequences in order, as ``jax.tree_util``
flattens the reference's trees, so the port's leaves of a tree come in the
order the reference's do. A path joins the keys and sequence indices that
lead to a leaf with "/", as the reference's ``_path_str`` does; the port's
per-layer list puts the layer index into the path ("layers/3/attn/...").
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...],
                                                         Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (str(i),))
    else:
        yield path, tree


_END = object()


class TreeDef(NamedTuple):
    """A tree's structure: ("dict", keys, children), ("list" | "tuple",
    None, children), ("namedtuple", type, children) or ("leaf", None, ())."""
    kind: str
    meta: Any
    children: tuple


def _structure(tree) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(_structure(tree[k]) for k in keys))
    if _is_namedtuple(tree):
        return TreeDef("namedtuple", type(tree),
                       tuple(_structure(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return TreeDef(type(tree).__name__, None,
                       tuple(_structure(x) for x in tree))
    return TreeDef("leaf", None, ())


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """(leaves in the reference's order, the structure to rebuild from)."""
    return [leaf for _, leaf in _walk(tree, ())], _structure(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "namedtuple":
            return d.meta(*kids)
        return kids if d.kind == "list" else tuple(kids)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("unflatten got more leaves than the tree has")
    return out


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """[(the leaf's "/"-joined path, leaf)] in :func:`flatten`'s order."""
    return [("/".join(p), leaf) for p, leaf in _walk(tree, ())]


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def count_params(tree) -> int:
    return sum(int(np.prod(_shape(x))) for x in flatten(tree)[0])


def tree_bytes(tree) -> int:
    total = 0
    for x in flatten(tree)[0]:
        if torch.is_tensor(x):
            size = x.element_size()
        elif hasattr(x, "dtype"):
            size = np.dtype(x.dtype).itemsize
        else:
            size = 4
        total += int(np.prod(_shape(x))) * size
    return total


def tree_map_with_path_names(fn: Callable[[str, Any], Any], tree):
    """fn(path, leaf) over every leaf, the paths "/"-joined."""
    leaves = [fn(path, leaf) for path, leaf in flatten_with_path(tree)]
    return unflatten(flatten(tree)[1], leaves)
