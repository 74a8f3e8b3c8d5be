"""Minimal pytree helpers over the port's containers.

A tree is a dict (keys in sorted order), a dataclass or ``NamedTuple``
(fields in order), a tuple or list, ``None`` (no leaves), or a leaf (a
tensor or a number).  The flattening order and the path strings are
``jax.tree_util``'s (``['key']``, ``.field``, ``[i]``), so a train state
flattens leaf for leaf like the reference's, which keeps the checkpoint
layout shared.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _children(node):
    """[(path step, child), ...] of a container, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"['{k}']", node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f'.{f.name}', getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return [(f'.{n}', getattr(node, n)) for n in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f'[{i}]', c) for i, c in enumerate(node)]
    return None


def _rebuild(node, children: List[Any]):
    """``node``'s container type around new ``children`` (in order)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if dataclasses.is_dataclass(node):
        return type(node)(**{f.name: c for f, c in
                             zip(dataclasses.fields(node), children)})
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """Every leaf with its path string, in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [('', tree)]
    return [(step + path, leaf) for step, child in kids
            for path, leaf in flatten_with_paths(child)]


def leaves(tree) -> List[Any]:
    """The leaves in flattening order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def go(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [go(c) for _, c in kids])

    out = go(tree)
    if next(it, None) is not None:
        raise ValueError('more leaves than the tree holds')
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure)."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
