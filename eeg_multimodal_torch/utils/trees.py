"""Parameter trees: nested dicts and lists of tensors, as in the JAX package."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree: Any):
    """Apply ``fn`` to every leaf; dicts and lists keep their structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf, paths '/'-joined (as the JAX
    package's ``utils/trees.path_str``), in the order of :func:`tree_items`."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, sub(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_items(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_size(tree: Any) -> int:
    """Total number of scalar elements."""
    return sum(leaf.numel() for _, leaf in tree_items(tree))


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating leaf to ``dtype`` (``utils/trees.py::tree_cast``
    of the JAX package); other leaves pass through. The cast is
    differentiable: a gradient taken through it reaches the source leaves
    in their own dtype."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)
