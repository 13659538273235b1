"""Parameter trees: nested dicts whose leaves are tensors (or anything with
a ``shape``), flattened in ``jax.tree_util`` order — dict keys sorted at
every level.  The flat order decides every packed offset, every pad
position, the selection jitter and the histogram sample, so the CNN's
``ravel_params`` and the packed layout share this one flattener."""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

Path = Tuple[str, ...]


def leaves(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order; a tree that is not a
    dict is one leaf with the empty path."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves(tree[key], path + (key,))
        return out
    return [(path, tree)]


def unflatten(paths: Sequence[Path], values: Sequence[Any]) -> Any:
    """The tree with ``values`` at ``paths`` (the inverse of ``leaves``)."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    out: dict = {}
    for path, value in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out
