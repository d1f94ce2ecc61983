"""Nested containers of tensors as trees, flattened in the order of JAX's
``tree_flatten``: dict keys sorted, lists and tuples in order, ``None`` an
empty subtree. The optimizer state and the checkpoint leaves follow this
order, so a leaf index means the same leaf in both packages. A
:class:`~repro_torch.utils.pspec.ParamTree` flattens as the dict it mirrors.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.utils.pspec import ParamTree


def _children(node) -> Tuple[str, list, Any]:
    """(kind, children, aux) of an inner node, or ("leaf", [], None)."""
    if node is None:
        return "none", [], None
    if isinstance(node, ParamTree):
        keys = sorted(node.keys())
        return "dict", [node[k] for k in keys], keys
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", [node[k] for k in keys], keys
    if isinstance(node, (list, tuple)):
        return type(node).__name__, list(node), None
    return "leaf", [], None


def tree_flatten(tree) -> Tuple[list, Any]:
    """(leaves, treedef): ``tree_unflatten(treedef, leaves)`` rebuilds it
    (a ParamTree comes back as a plain nested dict)."""
    kind, kids, aux = _children(tree)
    if kind == "leaf":
        return [tree], ("leaf",)
    leaves, defs = [], []
    for c in kids:
        lv, d = tree_flatten(c)
        leaves += lv
        defs.append(d)
    return leaves, (kind, aux, defs)


def tree_unflatten(treedef, leaves: list):
    it = iter(leaves)

    def build(d):
        if d[0] == "leaf":
            return next(it)
        kind, aux, defs = d
        kids = [build(c) for c in defs]
        if kind == "none":
            return None
        if kind == "dict":
            return dict(zip(aux, kids))
        return tuple(kids) if kind == "tuple" else kids

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilt as ``tree``'s structure."""
    leaves, d = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"trees differ: {len(leaves)} vs {len(o)} "
                             f"leaves")
    return tree_unflatten(d, [fn(*xs) for xs in zip(leaves, *others)])


def requires_grad(tree) -> bool:
    """True when any tensor leaf of ``tree`` requires grad."""
    return any(getattr(x, "requires_grad", False) for x in tree_leaves(tree))
