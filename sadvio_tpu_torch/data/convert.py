"""Carry state over from the JAX package.

``from_numpy(obj, device)`` turns a JAX-package pytree whose leaves are
numpy arrays (``jax.tree.map(np.asarray, obj)``) into the port's container
of the same name, recursively: ``Rig``/``Pinhole``, ``WindowState``,
``Observations``, ``PriorSet``, ``ImuChain``, ``Preintegration``,
``TrackState`` and ``ImuParams``.  Integer arrays become int64 tensors;
``ImuParams`` fields become floats.  Nothing here imports JAX: objects are
matched by class name and read field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _classes():
    from sadvio_tpu_torch.data import window
    from sadvio_tpu_torch.models import cameras, imu
    from sadvio_tpu_torch.pipeline.slam import TrackState

    return {c.__name__: c for c in (
        cameras.Pinhole, window.Rig, window.WindowState, window.Observations,
        window.PriorSet, window.ImuChain, imu.Preintegration, imu.ImuParams, TrackState)}


def _tensor(x, device):
    a = np.array(x, dtype=np.int64 if np.asarray(x).dtype.kind in "iu" else None)
    return torch.as_tensor(a, device=device)


def from_numpy(obj, device=None):
    """Port-side copy of a numpy-leaved JAX-package container."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return _tensor(obj, device)
    name = type(obj).__name__
    classes = _classes()
    if name not in classes or not dataclasses.is_dataclass(obj):
        raise TypeError(f"from_numpy: no port counterpart for {name}")
    cls = classes[name]
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
        if cls.__name__ == "ImuParams":
            kw[f.name] = float(np.asarray(val))
        elif isinstance(val, (int, float, bool, str)) and not isinstance(val, np.generic):
            kw[f.name] = val
        else:
            kw[f.name] = from_numpy(val, device)
    return cls(**kw)
