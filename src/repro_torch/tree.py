"""Nested containers of tensors (the port's pytrees): dicts, NamedTuples
(``TrainState``, ``AdamWState``) and ``None``.

Leaves are visited in JAX's flatten order: a dict by its sorted keys, a
NamedTuple field by field, ``None`` with no leaves.  A checkpoint of the
reference stores its leaves in that order, so the port reads one leaf by
leaf against its own tree (:mod:`repro_torch.ckpt.manager`).
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_paths", "tree_map", "tree_unflatten"]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key path, leaf) pairs in flatten order; a path joins dict keys and
    NamedTuple field names with ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure; returns a tree of that structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """A tree with ``template``'s structure whose leaves are ``leaves``,
    given in flatten order."""
    leaves = list(leaves)
    it = iter(leaves)

    def fill(t):
        if t is None:
            return None
        if isinstance(t, dict):
            vals = {k: fill(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(fill(x) for x in t))
        return next(it)

    n = len(tree_leaves(template))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    return fill(template)
