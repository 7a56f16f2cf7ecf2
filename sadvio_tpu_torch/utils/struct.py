"""Small dataclass containers of tensors with a functional ``replace``.

They take the place of the JAX package's ``flax.struct`` pytrees: fields
are tensors (or nested containers), ``replace`` returns a shallow copy with
some fields swapped, and ``tree_map`` maps a function over the tensor
leaves of several structurally equal containers at once.
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


def select(cond, a, b):
    """Leafwise ``torch.where(cond, a, b)`` over two equal containers."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def entry_device(device=None) -> torch.device:
    """Device of an entry point: the CUDA card unless the caller names one.

    ``None`` never means the CPU: without a card it raises, and a caller
    who wants the CPU says ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the card by default; "
                           "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
