"""Trees of dicts: the port's params, grads, optimizer state and specs.

The reference walks its pytrees with `jax.tree` in sorted-key order; the
port's trees are nested dicts (layer-stacked leaves included) walked
here in the same order, so a flat list of leaves, a bucket plan and a
checkpoint's leaf names come out as the reference's. A spec leaf is a
tuple, a state leaf a dict that `is_leaf` stops at.
"""
from __future__ import annotations


def flatten(tree, prefix=(), is_leaf=None) -> list:
    """[(path, leaf)] in sorted-key order (the reference's
    `jax.tree.flatten_with_path` order); `is_leaf` stops at a dict."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return [pl for k in sorted(tree)
                for pl in flatten(tree[k], prefix + (k,), is_leaf)]
    return [(prefix, tree)]


def unflatten(pairs) -> dict:
    """The tree of dicts `flatten` walked, from [(path, leaf)]."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def leaves(tree, is_leaf=None) -> list:
    """The leaves in `flatten`'s order."""
    return [leaf for _, leaf in flatten(tree, is_leaf=is_leaf)]


def tree_map(fn, tree, *rest, is_leaf=None):
    """fn over the leaves of a tree of dicts and of trees shaped like it."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)
