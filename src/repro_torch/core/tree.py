"""Nested dict / list / tuple trees of tensors in JAX's leaf order (dict
keys sorted, sequences and named tuples in order), so that sums over
leaves (the global gradient norm), a checkpoint's leaf numbering and a
mapping artifact's layer names follow the JAX package's
``jax.tree_util`` flatten order.  ``is_leaf`` stops the walk at the nodes
it accepts, as JAX's does."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Path = Tuple[Any, ...]
IsLeaf = Optional[Callable[[Any], bool]]


def leaves_with_paths(tree, prefix: Path = (),
                      is_leaf: IsLeaf = None) -> List[Tuple[Path, Any]]:
    """[(path, leaf)]: a path is the tuple of dict keys and sequence
    indices from the root; None is an empty subtree, as in JAX."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], prefix + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, prefix + (i,), is_leaf)]
    if tree is None:
        return []
    return [(prefix, tree)]


def leaves(tree, is_leaf: IsLeaf = None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def _rebuild(node, children):
    """A sequence node of ``node``'s type holding ``children``."""
    if hasattr(node, "_fields"):            # a named tuple
        return type(node)(*children)
    return type(node)(children)


def unflatten(tree, new_leaves, is_leaf: IsLeaf = None):
    """``tree``'s structure with its leaves replaced, in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(v) for v in node])
        if node is None:
            return None
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    others = [leaves(r, is_leaf) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree, is_leaf))],
                     is_leaf)


def structure(tree, is_leaf: IsLeaf = None) -> str:
    """The tree's structure in ``jax.tree_util``'s notation (``*`` for a
    leaf): ``{'a': *, 'b': (*, [*])}``; a named tuple is written
    ``CustomNode(namedtuple[Name], [...])``."""
    if is_leaf is not None and is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k], is_leaf)}"
                               for k in sorted(tree)) + "}"
    if hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(structure(v, is_leaf) for v in tree) + "])")
    if isinstance(tree, tuple):
        inner = ", ".join(structure(v, is_leaf) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(v, is_leaf) for v in tree) + "]"
    if tree is None:
        return "None"
    return "*"
