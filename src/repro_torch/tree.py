"""Parameter trees: nested dicts, lists and tuples whose leaves are
tensors (or anything with a ``shape``), flattened in ``jax.tree_util``
order — dict keys sorted at every level, lists and tuples by position,
``None`` skipped (it is an empty subtree there too).  The flat order
decides every packed offset, every pad position, the selection jitter and
the histogram sample, so the CNN's ``ravel_params``, the packed layout and
the optimizer share this one flattener.

A path is a tuple of dict keys (``str``) and positions: an ``int`` for a
list, a ``TupleIndex`` for a tuple, so that ``unflatten`` rebuilds each
container as it was.  A list position that has no leaf (a ``None``
element) comes back as ``None``; a dict entry whose value is ``None``
has no path and does not come back — ``tree_map`` keeps it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

Path = Tuple[Any, ...]


class TupleIndex(int):
    """A position inside a tuple (a list position is a plain ``int``)."""


def leaves(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order; a tree that is not a
    container is one leaf with the empty path."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves(tree[key], path + (key,))
        return out
    if isinstance(tree, (list, tuple)):
        kind = TupleIndex if isinstance(tree, tuple) else int
        out = []
        for i, sub in enumerate(tree):
            out += leaves(sub, path + (kind(i),))
        return out
    return [(path, tree)]


def unflatten(paths: Sequence[Path], values: Sequence[Any]) -> Any:
    """The tree with ``values`` at ``paths`` (the inverse of ``leaves``)."""
    items = list(zip(paths, values))
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    return _build(items)


def _build(items: List[Tuple[Path, Any]]) -> Any:
    groups: dict = {}
    for path, value in items:
        groups.setdefault(path[0], []).append((path[1:], value))

    def node(group):
        if len(group) == 1 and group[0][0] == ():
            return group[0][1]
        return _build(group)

    first = items[0][0][0]
    if isinstance(first, int):
        seq = [None] * (max(groups) + 1)
        for i, group in groups.items():
            seq[i] = node(group)
        return tuple(seq) if isinstance(first, TupleIndex) else seq
    return {key: node(group) for key, group in groups.items()}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping every container and every ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)
