"""Flattening of nested dicts and lists of leaves (the port's params trees).

The order is the one JAX flattens a pytree in: dict keys sorted, list items
by index. ``torch.autograd.Function`` takes tensors, not nested dicts, so the
kernels' differentiable wrappers pass the leaves flat in this order, and the
checkpoint keys of the two packages line up leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple


def tree_leaves(tree) -> List[Tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf; a path part is a dict key (str) or a
    list index (int)."""
    if isinstance(tree, dict):
        return [((k,) + path, leaf) for k in sorted(tree)
                for path, leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [((i,) + path, leaf) for i, v in enumerate(tree)
                for path, leaf in tree_leaves(v)]
    return [((), tree)]


def tree_from_leaves(paths: Sequence[tuple], leaves: Sequence[Any]):
    """The inverse of ``tree_leaves``: rebuild the nesting from the paths
    (integer parts become list positions)."""
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return nest_lists(root)


def nest_lists(node):
    """Turn the int-keyed dicts left by ``setdefault`` into ordered lists."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"sparse list indices {sorted(node)}")
            return [nest_lists(node[i]) for i in range(len(node))]
        return {k: nest_lists(v) for k, v in node.items()}
    return node
