"""Small dataclass containers of tensors with a functional ``replace``.

They take the place of the JAX package's ``flax.struct`` pytrees: fields
are tensors (or nested containers), ``replace`` returns a shallow copy with
some fields swapped, and ``tree_map`` maps a function over the tensor
leaves of several structurally equal containers at once; ``tree_leaves``
and ``tree_unflatten`` take a container apart into its tensors and put it
back together (``torch.func.vmap`` maps over tensors only).
"""

from __future__ import annotations

import dataclasses

import torch


class Struct:
    """Mixin for ``@dataclass`` containers of tensors."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return tree_map(lambda x: x.to(device), self)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to corresponding tensor leaves of ``tree`` and ``rest``.

    Dataclasses and NamedTuples are traversed; any other leaf that is not a
    tensor is taken from ``tree``.
    """
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kw = {}
        for f in dataclasses.fields(tree):
            kw[f.name] = tree_map(fn, getattr(tree, f.name),
                                  *[getattr(r, f.name) for r in rest])
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    return tree


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def tree_unflatten(template, leaves):
    """``template`` with its tensor leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def take(x, i):
    """``x[i]`` for a 0-d integer tensor ``i``, read on the device: indexing
    with a 0-d tensor reads it on the host, which a CUDA graph cannot
    capture."""
    return x.index_select(0, i.reshape(1))[0]


def select(cond, a, b):
    """Leafwise ``torch.where(cond, a, b)`` over two equal containers."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)

