"""Dict/list trees of tensors, flattened in JAX's leaf order.

The JAX package's parameter trees are nested dicts and lists. JAX flattens
a dict by *sorted* key, so the MLP's leaves come out as
``layers[0].b, layers[0].w, …, out.b, out.w``. The port depends on that
order in three places — the per-leaf reducer rng (``fold_in(rng, i)``),
the reverse-leaf streaming loop and ``LeafCost.path`` — and
``torch.utils._pytree`` keeps dict insertion order instead, so the port
carries its own small flattener.

Containers: ``dict`` (sorted keys), ``list`` and ``tuple`` (in order) and
``None`` (an empty tree, as in JAX). Everything else is a leaf. ``keystr``
paths match ``jax.tree_util.keystr``: ``"['layers'][0]['b']"``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

_LEAF = "leaf"


class TreeDef:
    """Structure of a flattened tree; ``unflatten`` rebuilds it."""

    __slots__ = ("kind", "keys", "children", "num_leaves")

    def __init__(self, kind: str, keys=(), children=()):
        self.kind = kind
        self.keys = tuple(keys)
        self.children = tuple(children)
        self.num_leaves = (1 if kind == _LEAF
                           else sum(c.num_leaves for c in self.children))

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys
                and self.children == other.children)

    def __hash__(self):
        return hash((self.kind, self.keys, self.children))

    def __repr__(self):
        return f"TreeDef({self.kind}, {self.keys}, {self.children})"

    def unflatten(self, leaves) -> Any:
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"expected {self.num_leaves} leaves, "
                             f"got {len(leaves)}")
        return self._build(iter(leaves))

    def _build(self, it):
        if self.kind == _LEAF:
            return next(it)
        if self.kind == "none":
            return None
        built = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, built))
        return tuple(built) if self.kind == "tuple" else built

    def flatten_up_to(self, tree) -> list:
        """Leaves of ``tree`` cut at this structure's leaves: each of this
        treedef's leaves may stand for a whole subtree of ``tree``."""
        out: list = []
        self._up_to(tree, out)
        return out

    def _up_to(self, tree, out):
        if self.kind == _LEAF:
            out.append(tree)
            return
        if self.kind == "none":
            if tree is not None:
                raise ValueError(f"expected None, got {type(tree).__name__}")
            return
        if self.kind == "dict":
            if not isinstance(tree, dict) or sorted(tree) != list(self.keys):
                raise ValueError(f"expected a dict with keys {self.keys}")
            subs = [tree[k] for k in self.keys]
        else:
            if not isinstance(tree, (list, tuple)) \
                    or len(tree) != len(self.children):
                raise ValueError(f"expected a {self.kind} of "
                                 f"{len(self.children)}")
            subs = list(tree)
        for c, s in zip(self.children, subs):
            c._up_to(s, out)


def _flatten(tree, path: str, leaves: list, paths: list) -> TreeDef:
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, dict):
        keys = sorted(tree)
        return TreeDef("dict", keys, [
            _flatten(tree[k], f"{path}[{k!r}]", leaves, paths)
            for k in keys])
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return TreeDef(kind, (), [
            _flatten(x, f"{path}[{i}]", leaves, paths)
            for i, x in enumerate(tree)])
    leaves.append(tree)
    paths.append(path)
    return TreeDef(_LEAF)


def tree_flatten(tree) -> Tuple[list, TreeDef]:
    """(leaves in JAX order, treedef)."""
    leaves: list = []
    treedef = _flatten(tree, "", leaves, [])
    return leaves, treedef


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """([(keystr path, leaf), …], treedef), paths as ``jax.tree_util.keystr``
    renders them."""
    leaves: list = []
    paths: list = []
    treedef = _flatten(tree, "", leaves, paths)
    return list(zip(paths, leaves)), treedef


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_structure(tree) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """Leafwise ``fn(leaf, *matching leaves of rest)``."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(x, *xs) for x, *xs in zip(leaves, *others)])


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_mean_leading(a):
    """Mean over the leading (client) axis of every leaf — the parameter
    average of Local SGD (Alg. 1 line 5)."""
    return tree_map(lambda x: torch.mean(x, dim=0), a)


def tree_broadcast_leading(a, n: int):
    """Replicate every leaf along a new leading axis of size n.

    A real copy, never an ``expand`` view: the client replicas are updated
    in place, each in its own memory.
    """
    return tree_map(
        lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous(),
        a)


def tree_to(a, device=None, dtype=None):
    """Move (and optionally cast) every leaf."""
    return tree_map(lambda x: torch.as_tensor(x).to(device=device,
                                                    dtype=dtype), a)


def tree_add(a, b):
    """Leafwise a + b."""
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    """Leafwise s * a for scalar s."""
    return tree_map(lambda x: x * s, a)


def tree_stack_leading(trees):
    """Stack a list of trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_take(a, i):
    """Index the leading axis of every leaf (client i's replica, a view)."""
    return tree_map(lambda x: x[i], a)


def tree_l2_norm(a):
    """Global l2 norm across all leaves, summed in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(a)))


def tree_size(a) -> int:
    """Total number of scalar parameters."""
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))
