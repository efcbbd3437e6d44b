"""Nested containers of tensors (the reference's pytrees).

A tree is a dict, a tuple, a list or a NamedTuple (``OptState``,
``ssm.MambaParams``) of trees, or a leaf. Leaves are listed in JAX's
order: dict keys sorted, sequences and NamedTuple fields in order. A
leaf's key is the reference checkpoint's: the dict key, the tuple index
or the NamedTuple field name of each level, joined by ``/``
(``0/classes/global/wq``, ``1/m/embed``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key, child) pairs in JAX's order; [] for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, tuple, list))


def keyed(tree) -> Dict[str, Any]:
    """Key -> leaf, in leaf order."""
    out: Dict[str, Any] = {}

    def walk(t, prefix):
        if _is_leaf(t):
            out["/".join(prefix)] = t
            return
        for k, c in _children(t):
            walk(c, prefix + (k,))
    walk(tree, ())
    return out


def leaves(tree) -> List[Any]:
    return list(keyed(tree).values())


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    out = [map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
    return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)


def unflatten_like(like, values: Iterator) -> Any:
    """A tree shaped like ``like`` whose leaves, in leaf order, are the
    next items of ``values``."""
    if _is_leaf(like):
        return next(values)
    if isinstance(like, dict):
        got = {k: unflatten_like(like[k], values) for k in sorted(like)}
        return {k: got[k] for k in like}
    out = [unflatten_like(c, values) for c in like]
    return type(like)(*out) if _is_namedtuple(like) else type(like)(out)
