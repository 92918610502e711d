"""Nested containers of tensors (pytrees) in the JAX package's order.

JAX flattens a dict in sorted key order, a list or tuple by index and a
NamedTuple by field, and treats ``None`` as a subtree with no leaves; the
checkpoint manager names each leaf by its path (``opt/.m/a/0``), so the
order and the names are part of its on-disk format.  PyTorch's own pytree
keeps a dict's insertion order, so the port flattens with this module.

Path entries are strings: a dict key as ``str(key)``, a list or tuple index
as ``str(i)``, a NamedTuple field as ``.field`` (the way JAX prints its
``GetAttrKey``).  Anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

#: a tree's structure: ("leaf",), ("none",), ("dict", keys, children),
#: ("list" | "tuple", children) or ("namedtuple", type, children)
TreeDef = tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _walk(x: Any, path: Tuple[str, ...], out: List[Tuple[Tuple[str, ...], Any]]) -> TreeDef:
    if x is None:
        return ("none",)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_walk(x[k], path + (str(k),), out) for k in keys))
    if _is_namedtuple(x):
        return ("namedtuple", type(x),
                tuple(_walk(v, path + (f".{f}",), out) for f, v in zip(x._fields, x)))
    if isinstance(x, (list, tuple)):
        kind = "list" if isinstance(x, list) else "tuple"
        return (kind, tuple(_walk(v, path + (str(i),), out) for i, v in enumerate(x)))
    out.append((path, x))
    return ("leaf",)


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[Tuple[str, ...], Any]], TreeDef]:
    """([(path, leaf), ...] in JAX's order, the tree's structure)."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    treedef = _walk(tree, (), out)
    return out, treedef


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    """[(name, leaf), ...]: the path joined with "/" ("leaf" for a bare
    leaf), the names of the JAX package's checkpoint manager."""
    return [("/".join(path) or "leaf", leaf) for path, leaf in flatten_with_path(tree)[0]]


def _build(treedef: TreeDef, it: Iterator[Any]) -> Any:
    kind = treedef[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(treedef[1], treedef[2])}
    if kind == "namedtuple":
        return treedef[1](*(_build(c, it) for c in treedef[2]))
    children = [_build(c, it) for c in treedef[1]]
    return children if kind == "list" else tuple(children)


def unflatten(treedef: TreeDef, leaves_: List[Any]) -> Any:
    it = iter(leaves_)
    out = _build(treedef, it)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def flatten_like(treedef: TreeDef, tree: Any) -> List[Any]:
    """The leaves of ``tree``, which must have the structure ``treedef``."""
    got, td = flatten(tree)
    if td != treedef:
        raise ValueError("tree structures differ")
    return got


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure; dicts match by key)."""
    flat, treedef = flatten(tree)
    others = [flatten_like(treedef, r) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
