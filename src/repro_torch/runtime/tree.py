"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked in
the reference's order (``jax.tree_util``: dict keys sorted, sequences and
NamedTuple fields in order), so that leaf lists and checkpoint file names
line up with the JAX package's."""
from __future__ import annotations


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure.
    A leaf is anything that is not a dict, list or tuple; ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree, prefix=()) -> list:
    """``[(path, leaf), ...]`` in the reference's order; a path is a tuple
    of dict keys, sequence indices and NamedTuple fields as ``".field"``
    (how ``jax.tree_util`` prints a field's key)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_paths(v, prefix + (k,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` in the order of
    :func:`tree_paths`."""
    paths = [p for p, _ in tree_paths(like)]
    leaves = list(leaves)
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    filled = dict(zip(paths, leaves))

    def build(t, prefix):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k], prefix + (k,)) for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v, prefix + (f".{f}",))
                             for f, v in zip(t._fields, t)))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return filled[prefix]

    return build(like, ())
