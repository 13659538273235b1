"""Parameter trees as nested dicts and lists of tensors, flattened with
dict keys sorted at every level and lists by position: the order that
decides every packed offset, pad, jitter and histogram sample of the
server state."""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

Path = Tuple[Any, ...]


def leaves(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in flattening order."""
    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in leaves(tree[key], path + (key,))]
    if isinstance(tree, list):
        return [pl for i, sub in enumerate(tree)
                for pl in leaves(sub, path + (i,))]
    return [(path, tree)]


def unflatten(paths: Sequence[Path], values: Sequence[Any]) -> Any:
    """The nested dicts and lists with ``values`` at ``paths``."""
    root: Any = None
    for path, value in zip(paths, values):
        if root is None:
            root = [] if isinstance(path[0], int) else {}
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            empty = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = empty
            else:
                node.setdefault(key, empty)
            node = node[key]
        last = path[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = value
    return root


def path_name(path: Path) -> str:
    return "/".join(str(k) for k in path)
