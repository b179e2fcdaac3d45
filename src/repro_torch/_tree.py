"""Pytrees over dict, list, tuple and namedtuple, and numpy<->torch.

The reference walks its values with ``jax.tree``; the port needs the same
few operations over torch tensors. A leaf is anything that is not one of
the four containers. Dict keys keep their insertion order.

numpy has no bfloat16. Arrays of the reference's bfloat16 (the
``ml_dtypes`` extension type) are recognised by dtype name and moved as
their 16-bit pattern, so the port never imports ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch


def tree_map(f: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply ``f`` to each leaf (and the matching leaves of ``rest``);
    ``is_leaf`` stops the walk at a container it accepts, as in
    ``jax.tree.map``."""
    if is_leaf is not None and is_leaf(tree):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(f, *xs, is_leaf=is_leaf) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [tree_map(f, *xs, is_leaf=is_leaf) for xs in zip(tree, *rest)]
    return f(tree, *rest)


def tree_leaves(tree: Any,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    out: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)

    walk(tree)
    return out


def leaves_up_to(prefix: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` found where ``prefix`` has a leaf, in
    ``tree_leaves(prefix)`` order (``tree`` extends ``prefix``'s
    structure)."""
    out: List[Any] = []

    def walk(p, t):
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, t[k])
        elif isinstance(p, (list, tuple)):
            for v, w in zip(p, t):
                walk(v, w)
        else:
            out.append(t)

    walk(prefix, tree)
    return out


def unflatten_like(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def to_device(tree: Any, device) -> Any:
    """Move every tensor leaf to ``device``; a tensor already there is
    returned as is. Other leaves are left alone."""
    return tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def host_copy(tree: Any) -> Any:
    """Host copies that share no storage with ``tree``: tensors become
    CPU tensors (a bfloat16 tensor stays bfloat16), numpy arrays are
    copied, other leaves are kept."""
    def cp(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return np.array(x)
        return x
    return tree_map(cp, tree)


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy array (including the reference's bfloat16) -> CPU tensor."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # torch tensors are always writable
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)

