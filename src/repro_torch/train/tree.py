"""Trees of tensors: nested dicts, lists and NamedTuples (the parameter,
gradient and optimizer-state trees of the train package).

Leaves come in ``jax.tree``'s order: a dict's keys sorted, a list's or a
NamedTuple's entries in order.  That order fixes the sum in
``optimizer.global_norm``, and the key paths are the checkpoint's leaf
names (``checkpoint.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def items_with_path(tree, prefix: Tuple[str, ...] = ()
                    ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf; a path names dict keys, list
    indices and NamedTuple fields as strings.  ``None`` is no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items_with_path(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from items_with_path(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items_with_path(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in items_with_path(tree)]


def unflatten(template, values) -> Any:
    """``template``'s structure with its leaves replaced, in
    :func:`leaves` order, by ``values``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}      # the template's key order
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``'s
    structure, which every tree of ``rest`` shares."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])
