"""Walks over nested dict/list parameter trees with '/'-joined paths.

The port keeps per-layer weights as a Python list under ``blocks``, so a
leaf's path carries its layer index (``blocks/3/attn/wq``) where the
reference's stacked tree has ``blocks/attn/wq``; ``reference_path``
converts one to the other.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Tuple

_LAYER = re.compile(r"^blocks/\d+/")


def _children(tree: Any):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every non-container leaf, depth first."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, sub in kids:
        yield from tree_items(sub, f"{prefix}/{key}" if prefix else str(key))


def tree_map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                       prefix: str = "") -> Any:
    """Rebuild ``tree`` with ``fn(path, leaf, *rest_leaves)`` at each leaf.

    ``rest`` trees share ``tree``'s containers; their leaves ride along.
    """
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree, *rest)
    out = {} if isinstance(tree, dict) else []
    for key, sub in kids:
        path = f"{prefix}/{key}" if prefix else str(key)
        val = tree_map_with_path(fn, sub, *(r[key] for r in rest),
                                 prefix=path)
        if isinstance(out, dict):
            out[key] = val
        else:
            out.append(val)
    return out


def reference_path(path: str) -> str:
    """``blocks/<l>/...`` -> ``blocks/...``: the reference's stacked path."""
    return _LAYER.sub("blocks/", path)


def is_layer_path(path: str) -> bool:
    """A leaf of one layer of an LM's ``blocks`` list: the reference
    stacks it on a leading layer axis."""
    return _LAYER.match(path) is not None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *rest_leaves)`` at every leaf (``None`` leaves included:
    ``fn`` sees them)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Every non-``None`` leaf, depth first."""
    return [leaf for _, leaf in tree_items(tree) if leaf is not None]


def unflatten(flat: Dict[str, Any]) -> Any:
    """The tree of ``{'/'-path: leaf}``: a level whose keys are all digits
    becomes a list (an LM's ``blocks``), any other a dict."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *heads, last = path.split("/")
        for key in heads:
            node = node.setdefault(key, {})
        node[last] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)
