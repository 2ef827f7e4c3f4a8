"""Nested dicts, lists and tuples of tensors: the port's parameter, cache
and optimizer-state trees. Leaves come in the order `jax.tree.leaves` gives
the reference's trees (dict keys sorted), so sums over a tree add in the
reference's order."""
from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    in a tree of `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return None if tree is None else fn(tree, *rest)


def unflatten_like(tree, flat: list):
    """A tree of `tree`'s structure whose leaves are `flat`, in `leaves`
    order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        return None if t is None else next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
