"""Carry state over from the JAX package.

``from_numpy(obj, device)`` turns a JAX-package pytree whose leaves are
numpy arrays (``jax.tree.map(np.asarray, obj)``) into the port's container
of the same name, recursively: ``Rig`` with any camera model (``Pinhole``,
``DoubleSphere``, ``Fisheye``, ``Omni``), ``WindowState``,
``Observations``, ``PriorSet``, ``ImuChain``, ``Preintegration``,
``TrackState``, ``GlobalMap`` and ``ImuParams``.  Integer arrays become
int64 tensors; ``ImuParams`` fields become floats; packed BRIEF descriptors
((N,8) uint32 words) become the port's (N,256) bool rows.  Nothing here
imports JAX: objects are matched by class name and read field by field.

``slam_state_from_numpy`` carries the long-run state of a JAX-package
``StereoSLAM`` (global map, slot descriptors, archive, pose-graph edges and
the mesher's triangles), ``MonoSLAM``'s bootstrap and VIInit settings and
``NoFovSLAM``'s camera-1 host state into the port's pipeline of the same
class.  ``pyramid_from_numpy`` crops the JAX package's edge-padded pyramid
levels to the port's unpadded ones.
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
        cameras.Pinhole, cameras.DoubleSphere, cameras.Fisheye, cameras.Omni, window.Rig,
        window.WindowState, window.Observations, window.PriorSet, window.ImuChain,
        imu.Preintegration, imu.ImuParams, TrackState, GlobalMap)}


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


def pyramid_from_numpy(levels, device=None):
    """One camera's pyramid of the JAX package (level 0 full size, coarser
    levels edge-padded) as the port's tuple of unpadded level tensors: level
    l keeps the top-left (H_{l-1} // 2, W_{l-1} // 2) of its array."""
    H, W = np.asarray(levels[0]).shape
    out = []
    for lvl in levels:
        out.append(torch.as_tensor(np.array(np.asarray(lvl)[:H, :W], np.float32), device=device))
        H, W = H // 2, W // 2
    return tuple(out)


def slam_state_from_numpy(slam, *, global_map=None, lmk_desc=None, archived_kf=None,
                          pose_graph_edges=None, kf_cov=None, mesh=None, boot=None,
                          vio_init_kfs=None, vi_opt_scale=None, scale_state=None, uv1_last=None,
                          v1_last=None, uv1_hist=None, hist_mask=None, pyr1_hist=None):
    """Continue a JAX-package run's state in the port's ``slam``.

    global_map: numpy-leaved GlobalMap; lmk_desc: (L,8) uint32 slot
    descriptors; archived_kf: [(ts, R, t)]; pose_graph_edges: [(ts0, ts1,
    dx (6,), inf (6,6))]; kf_cov: the per-window-keyframe (6,6) covariances;
    mesh: the mesher's (tri (T,3), tri_mask (T,)).  ``MonoSLAM``: boot, the
    pending bootstrap ({"pyr0": per-camera pyramids, "uv0", "uv", "valid",
    "ts0"} or None); vio_init_kfs; vi_opt_scale.  ``NoFovSLAM``:
    scale_state ({"applied", "s", "n_est"}); uv1_last (L,2), v1_last (L,),
    uv1_hist (K,L,2), hist_mask (K,L) on the host; pyr1_hist, camera 1's
    pyramid (or None) per window slot.  Timestamps stay host float64, poses
    and edge blocks host numpy; tensors go to the device of ``slam``."""
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
    if boot is not None:
        slam._boot = {"pyr0": tuple(pyramid_from_numpy(p, dev) for p in boot["pyr0"]),
                      "ts0": float(boot["ts0"]),
                      **{k: _tensor(boot[k], dev) for k in ("uv0", "uv", "valid")}}
    if vio_init_kfs is not None:
        slam.vio_init_kfs = int(vio_init_kfs)
    if vi_opt_scale is not None:
        slam._vi_opt_scale = bool(vi_opt_scale)
    if scale_state is not None:
        slam.scale_state = {"applied": bool(scale_state["applied"]),
                            "s": float(scale_state["s"]), "n_est": int(scale_state["n_est"])}
    for name, val, dt in (("uv1_last", uv1_last, np.float32), ("v1_last", v1_last, bool),
                          ("uv1_hist", uv1_hist, np.float32), ("hist_mask", hist_mask, bool)):
        if val is not None:
            setattr(slam, name, np.array(val, dt))
    if pyr1_hist is not None:
        slam.pyr1_hist = [None if p is None else pyramid_from_numpy(p, dev) for p in pyr1_hist]
    return slam
