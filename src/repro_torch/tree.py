"""Parameter trees in the JAX package's pytree order.

A tree is dicts, lists, tuples and NamedTuples of tensors (or numpy arrays
and Python scalars); ``None`` holds no leaf.  Leaves come in the order
``jax.tree_util`` gives them: a dict's children by sorted key, a list's,
tuple's or NamedTuple's in order.  The optimizer, the checkpoints and the
train step walk trees in that order, so leaf ``i`` of a checkpoint is the
same leaf in both packages, and each leaf's path string (``"0/layers/1/
mlp/0/w"``) is the one ``repro.checkpoint`` writes.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    """``(key, child)`` pairs of a container node, in flatten order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return [(str(i), v) for i, v in enumerate(node)]


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


# The walkers recurse through module-level functions that take their
# accumulators as arguments: a nested recursive function refers to itself
# through its closure, a reference cycle that would keep every leaf it
# collected alive until the garbage collector runs (a training step's
# whole parameter, gradient and moment trees, tens of GB on the card).

def _walk_paths(node, prefix, paths, leaves) -> None:
    if node is None:
        return
    if _is_container(node):
        for key, child in _children(node):
            _walk_paths(child, prefix + (key,), paths, leaves)
    else:
        paths.append("/".join(prefix))
        leaves.append(node)


def flatten_with_paths(tree) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) in flatten order."""
    paths, leaves = [], []
    _walk_paths(tree, (), paths, leaves)
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten_with_paths(tree)[1]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}               # the template's order
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(v, it) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(template, new_leaves) -> Any:
    """A tree of ``template``'s structure holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out


def _walk_up_to(t, node, out) -> None:
    if t is None:
        return
    if _is_container(t):
        kids = dict(_children(node))
        for key, child in _children(t):
            _walk_up_to(child, kids[key], out)
    else:
        out.append(node)


def flatten_up_to(template, tree) -> List[Any]:
    """``tree``'s subtrees at the positions of ``template``'s leaves (JAX's
    ``treedef.flatten_up_to``): the optimizer's moment trees, whose leaves
    may themselves be ``QTensor`` pairs."""
    out = []
    _walk_up_to(template, tree, out)
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``), in ``tree``'s structure."""
    others = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *others)])
