"""Nested dicts / lists / tuples of tensors (the port's counterpart of a
JAX pytree): map, leaves with their paths, and rebuilding a tree from
its leaves.  Leaves are visited in a fixed order (dict insertion order,
sequence index), so two trees of one structure line up leaf by leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

Path = Tuple[Any, ...]


def map_tree(fn: Callable, tree):
    """``fn`` on every leaf, in a tree of the same structure."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]``: a path is the tuple of dict keys and
    sequence indices from the root to the leaf."""
    if isinstance(tree, Mapping):
        return [pl for k, v in tree.items()
                for pl in leaves_with_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves):
    """A tree shaped like ``template`` holding ``new_leaves`` in leaf
    order; raises if the counts differ."""
    it = iter(new_leaves)
    out = map_tree(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out
