"""Carry state over from the JAX package.

``from_numpy(obj, device)`` turns a JAX-package pytree whose leaves are
numpy arrays (``jax.tree.map(np.asarray, obj)``) into the port's container
of the same name, recursively: ``Rig``/``Pinhole``, ``WindowState``,
``Observations``, ``PriorSet``, ``ImuChain``, ``Preintegration``,
``TrackState``, ``GlobalMap`` and ``ImuParams``.  Integer arrays become
int64 tensors; ``ImuParams`` fields become floats; packed BRIEF descriptors
((N,8) uint32 words) become the port's (N,256) bool rows.  Nothing here
imports JAX: objects are matched by class name and read field by field.

``slam_state_from_numpy`` carries the long-run state of a JAX-package
``StereoSLAM`` (global map, slot descriptors, archive, pose-graph edges and
the mesher's triangles) into a port ``StereoSLAM``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _classes():
    from sadvio_tpu_torch.data import window
    from sadvio_tpu_torch.data.globalmap import GlobalMap
    from sadvio_tpu_torch.models import cameras, imu
    from sadvio_tpu_torch.pipeline.slam import TrackState

    return {c.__name__: c for c in (
        cameras.Pinhole, window.Rig, window.WindowState, window.Observations,
        window.PriorSet, window.ImuChain, imu.Preintegration, imu.ImuParams, TrackState,
        GlobalMap)}


def _tensor(x, device):
    a = np.array(x, dtype=np.int64 if np.asarray(x).dtype.kind in "iu" else None)
    return torch.as_tensor(a, device=device)


def unpack_descriptors(words, device=None):
    """(N,8) uint32 packed BRIEF words -> (N,256) bool tensor: bit b of a
    descriptor is bit b % 32 (least significant first) of word b // 32."""
    w = np.ascontiguousarray(np.asarray(words).astype("<u4"))
    bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[0], -1), axis=1, bitorder="little")
    return torch.as_tensor(bits.astype(bool), device=device)


def from_numpy(obj, device=None):
    """Port-side copy of a numpy-leaved JAX-package container."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return _tensor(obj, device)
    name = type(obj).__name__
    classes = _classes()
    if name not in classes or not (dataclasses.is_dataclass(obj) or hasattr(obj, "_fields")):
        raise TypeError(f"from_numpy: no port counterpart for {name}")
    cls = classes[name]
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
        if cls.__name__ == "GlobalMap" and f.name == "desc":
            kw[f.name] = unpack_descriptors(val, device)
        elif cls.__name__ == "ImuParams":
            kw[f.name] = float(np.asarray(val))
        elif isinstance(val, (int, float, bool, str)) and not isinstance(val, np.generic):
            kw[f.name] = val
        else:
            kw[f.name] = from_numpy(val, device)
    return cls(**kw)


def slam_state_from_numpy(slam, *, global_map=None, lmk_desc=None, archived_kf=None,
                          pose_graph_edges=None, kf_cov=None, mesh=None):
    """Continue a JAX-package run's long-run state in the port's ``slam``.

    global_map: numpy-leaved GlobalMap; lmk_desc: (L,8) uint32 slot
    descriptors; archived_kf: [(ts, R, t)]; pose_graph_edges: [(ts0, ts1,
    dx (6,), inf (6,6))]; kf_cov: the per-window-keyframe (6,6) covariances;
    mesh: the mesher's (tri (T,3), tri_mask (T,)).  Timestamps stay host
    float64, poses and edge blocks host numpy; tensors go to the device of
    ``slam``."""
    dev = slam.device
    if global_map is not None:
        slam.global_map_state = from_numpy(global_map, dev)
    if lmk_desc is not None:
        slam.lmk_desc = unpack_descriptors(lmk_desc, dev)
    if archived_kf is not None:
        slam.archived_kf = [(float(ts), np.array(R, np.float32), np.array(t, np.float32))
                            for ts, R, t in archived_kf]
    if pose_graph_edges is not None:
        slam.pose_graph_edges = [(float(a), float(b), np.array(dx, np.float64),
                                  np.array(inf, np.float64))
                                 for a, b, dx, inf in pose_graph_edges]
    if kf_cov is not None:
        slam.kf_cov = [np.array(c, np.float64) for c in kf_cov]
    if mesh is not None:
        tri, tri_mask = mesh
        slam.mesher.tri = torch.as_tensor(np.asarray(tri).astype(np.int64), device=dev)
        slam.mesher.tri_mask = torch.as_tensor(np.asarray(tri_mask).astype(bool), device=dev)
    return slam
