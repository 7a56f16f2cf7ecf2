"""Checkpoint and resume of the estimator state, in the JAX package's format.

Port of ``sadvio_tpu/utils/checkpoint.py``.  One ``.npz`` file holds the
device state as numbered arrays ``arr_0 ... arr_N`` and the host state as
the JSON string ``meta``; files written by either package load into the
other.  The arrays are the leaves of the JAX package's state dict, in the
order ``jax.tree_util`` flattens it: the dict keys sorted (``STATE_KEYS``),
then each container's fields in declaration order, which the port's
dataclasses share.  Each leaf is written with the JAX leaf's shape and
dtype:

* integer tensors (int64 in the port) as int32, floats as float32;
* BRIEF descriptors (the port's (N,256) bool rows) packed into (N,8)
  uint32 words, and unpacked on load;
* ``key``, the JAX package's uint32[2] PRNG key: the port draws from a
  ``torch.Generator`` instead, so it carries the key through unchanged and
  writes the generator's state into ``meta["torch_generator"]``.  A file
  without that state (a JAX file, or one saved on another device type)
  seeds the generator with ``(key[0] << 32) | key[1]``: the seed itself for
  a JAX instance that has not drawn yet, deterministic in every case.

State the JAX format has no leaf for goes into ``meta`` only, never into
extra arrays: the JAX reader sorts the arrays by number and asserts their
count.  The port adds ``torch_generator`` and nothing else; the typed
channels, the monocular bootstrap, the nofov camera-1 tracks and the
mesher's triangles are not saved (as in the JAX package).  Tracking
templates are not saved either: the caller hands over ``kf_pyr``.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os

import numpy as np
import torch

# the top-level keys of the state dict, in jax.tree_util's (sorted) order;
# "gm" and "lmk_desc" only with a global map
STATE_KEYS = ("R_cur", "dT", "gm", "imu", "key", "lmk_desc", "obs", "pre_cur", "priors",
              "t_cur", "tracks", "v_cur", "window")
DESC_PATHS = ("gm.desc", "lmk_desc")  # packed to uint32 words in the file


def _device_state(slam):
    state = {"window": slam.window, "obs": slam.obs, "priors": slam.priors, "imu": slam.imu,
             "tracks": slam.tracks, "pre_cur": slam.pre_cur, "R_cur": slam.R_cur,
             "t_cur": slam.t_cur, "v_cur": slam.v_cur, "dT": slam.dT, "key": slam.key}
    if slam.global_map_state is not None:
        state["gm"] = slam.global_map_state
        state["lmk_desc"] = slam.lmk_desc
    return {k: state[k] for k in STATE_KEYS if k in state}


def _flatten(x, path=""):
    """[(path, leaf)] of a state nest in the JAX package's leaf order."""
    if isinstance(x, dict):
        return [pl for k, v in x.items() for pl in _flatten(v, k)]
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return [pl for i, v in enumerate(x) for pl in _flatten(v, f"{path}.{i}")]
    if dataclasses.is_dataclass(x):
        return [pl for f in dataclasses.fields(x)
                for pl in _flatten(getattr(x, f.name), f"{path}.{f.name}")]
    return [(path, x)]


def _unflatten(x, leaves):
    """``x`` with its leaves replaced, in ``_flatten`` order, from the
    iterator ``leaves``."""
    if isinstance(x, dict):
        return {k: _unflatten(v, leaves) for k, v in x.items()}
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_unflatten(v, leaves) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _unflatten(getattr(x, f.name), leaves)
                                         for f in dataclasses.fields(x)})
    return next(leaves)


def leaf_paths(slam):
    """The dotted paths of the file's arrays, in order (``window.R``,
    ``dT.0``, ``imu.pre.dR``, ...)."""
    return [p for p, _ in _flatten(_device_state(slam))]


def pack_descriptors(bits):
    """(N,256) bool -> (N,8) uint32: bit b is bit b % 32 (least significant
    first) of word b // 32, the inverse of ``data.convert.unpack_descriptors``."""
    b = np.asarray(bits, bool)
    return np.packbits(b, axis=1, bitorder="little").view("<u4").astype(np.uint32)


def _to_file(path, leaf):
    """A port leaf as the JAX package stores it."""
    a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    if path in DESC_PATHS:
        return pack_descriptors(a)
    if a.dtype.kind in "iu" and path != "key":
        return a.astype(np.int32)
    if a.dtype.kind == "f":
        return a.astype(np.float32)
    return a


def _from_file(path, arr, like, device):
    """A file array as the port's leaf ``like``."""
    from sadvio_tpu_torch.data.convert import unpack_descriptors

    if path == "key":
        return np.asarray(arr, np.uint32)
    if path in DESC_PATHS:
        return unpack_descriptors(arr, device)
    return torch.as_tensor(np.asarray(arr), device=device).to(like.dtype)


def _file_shape(path, leaf):
    shape = tuple(leaf.shape)
    return shape[:-1] + (8,) if path in DESC_PATHS else shape


def save_slam(path: str, slam) -> None:
    """Serialize the estimator state of a StereoSLAM (or subclass)."""
    # a pending async health fetch holds the latest frame's trajectory row
    slam._flush_health()
    leaves = [_to_file(p, x) for p, x in _flatten(_device_state(slam))]
    gen = slam.gen
    meta = {
        "n_kf": slam.n_kf, "initialized": slam.initialized,
        "vi_initialized": slam.vi_initialized, "have_priors": slam._have_priors,
        "imu_n": slam._imu_n, "n_resets": slam.n_resets, "kf_ts": list(slam.kf_ts),
        "kf_cov": [np.asarray(c).tolist() for c in slam.kf_cov],
        "cov_h": np.asarray(slam._cov_h).tolist(),
        "ba_h": np.asarray(slam._ba_h).tolist(), "bg_h": np.asarray(slam._bg_h).tolist(),
        "successive_fails": slam.successive_fails,
        "traj": [(ts, np.asarray(R).tolist(), np.asarray(t).tolist()) for ts, R, t in slam.traj],
        "kf_traj": [(ts, np.asarray(R).tolist(), np.asarray(t).tolist())
                    for ts, R, t in slam.kf_traj],
        "archived_kf": [(ts, np.asarray(R).tolist(), np.asarray(t).tolist())
                        for ts, R, t in slam.archived_kf],
        "pose_graph_edges": [(ts0, ts1, np.asarray(dx).tolist(), np.asarray(inf).tolist())
                             for ts0, ts1, dx, inf in slam.pose_graph_edges],
        "vio_log": [list(map(float, r)) for r in slam.vio_log],
        "last_health": ([float(slam._last_health[0]), np.asarray(slam._last_health[1]).tolist()]
                        if slam._last_health is not None else None),
        "torch_generator": {"device": gen.device.type,
                            "state": base64.b64encode(gen.get_state().numpy().tobytes()).decode()},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, *leaves, meta=json.dumps(meta).encode())


def load_slam(path: str, slam) -> None:
    """Restore a state saved by either package's ``save_slam`` into ``slam``
    (in place).  ``slam`` must be built with the same capacities and config
    (leaf count and shapes are asserted)."""
    data = np.load(path, allow_pickle=False)
    state = _device_state(slam)
    flat = _flatten(state)
    names = sorted((k for k in data.files if k != "meta"), key=lambda s: int(s.split("_")[1]))
    loaded = [data[n] for n in names]
    paths = [p for p, _ in flat]
    if len(loaded) == len(flat) - 1 and "gm" in state:
        # a file saved before GlobalMap gained its ``src`` leaf: splice in the
        # neutral default (-1, no archiving-keyframe provenance)
        pos = paths.index("gm.src")
        loaded.insert(pos, np.full(tuple(flat[pos][1].shape), -1, np.int32))
    assert len(loaded) == len(flat), "checkpoint/leaf count mismatch"
    new = []
    for (p, old), arr in zip(flat, loaded):
        assert arr.shape == _file_shape(p, old), f"checkpoint shape mismatch at {p}"
        new.append(_from_file(p, arr, old, slam.device))
    state = _unflatten(state, iter(new))
    slam.window, slam.obs, slam.priors = state["window"], state["obs"], state["priors"]
    slam.imu, slam.tracks, slam.pre_cur = state["imu"], state["tracks"], state["pre_cur"]
    slam.R_cur, slam.t_cur, slam.v_cur = state["R_cur"], state["t_cur"], state["v_cur"]
    slam.dT, slam.key = state["dT"], state["key"]
    if "gm" in state:
        slam.global_map_state, slam.lmk_desc = state["gm"], state["lmk_desc"]
    meta = json.loads(bytes(data["meta"]).decode())
    slam.n_kf = int(meta["n_kf"])
    slam.initialized = bool(meta["initialized"])
    slam.vi_initialized = bool(meta.get("vi_initialized", not slam.vio))
    slam._have_priors = bool(meta.get("have_priors", False))
    slam._imu_n = int(meta.get("imu_n", 0))
    slam.n_resets = int(meta.get("n_resets", 0))
    slam.kf_ts = list(meta.get("kf_ts", []))
    # per-keyframe frame covariances weight the pose-graph edges; a file
    # from before they were saved restores zeros (neutral weight)
    kf_cov = meta.get("kf_cov")
    slam.kf_cov = ([np.asarray(c) for c in kf_cov] if kf_cov is not None
                   else [np.zeros((6, 6)) for _ in slam.kf_ts])
    slam._cov_h = np.asarray(meta.get("cov_h", np.zeros((6, 6))))
    slam._ba_h = np.asarray(meta.get("ba_h", [0.0] * 3))
    slam._bg_h = np.asarray(meta.get("bg_h", [0.0] * 3))
    slam.successive_fails = int(meta["successive_fails"])
    slam.traj = [(ts, np.asarray(R), np.asarray(t)) for ts, R, t in meta["traj"]]
    slam.kf_traj = [(ts, np.asarray(R), np.asarray(t)) for ts, R, t in meta["kf_traj"]]
    slam.archived_kf = [(ts, np.asarray(R), np.asarray(t))
                        for ts, R, t in meta.get("archived_kf", [])]
    slam.pose_graph_edges = [(ts0, ts1, np.asarray(dx), np.asarray(inf))
                             for ts0, ts1, dx, inf in meta.get("pose_graph_edges", [])]
    slam.vio_log = [tuple(r) for r in meta.get("vio_log", [])]
    # no in-flight fetch or vote state of the live instance survives a load
    slam._health_pend = None
    slam._health_stale = False
    slam._par_prev = None
    lh = meta.get("last_health")
    slam._last_health = (lh[0], np.asarray(lh[1])) if lh is not None else None
    gen = meta.get("torch_generator")
    if gen is not None and gen["device"] == slam.gen.device.type:
        raw = np.frombuffer(base64.b64decode(gen["state"]), np.uint8)
        slam.gen.set_state(torch.from_numpy(raw.copy()))
    else:
        slam.gen.manual_seed((int(slam.key[0]) << 32) | int(slam.key[1]))
