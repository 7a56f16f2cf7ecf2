"""Checkpoints: the port's save/load, and files that cross between packages.

World and config of tests/test_checkpoint.py (seed 9, 24 frames, 320x240,
bimono, K=6, L=160), with ``global_map`` on so the descriptor leaves and
``gm.src`` are in the file.  Each package saves after frame 12.

Tolerances: a port resume continues the saved run within 1e-6 m
(tests/test_checkpoint.py's bound); the port's leaf paths, shapes and
dtypes equal JAX's ``tree_flatten_with_path`` exactly; a JAX file's leaves
load into the port bit for bit; a port file loaded by
``sadvio_tpu.utils.checkpoint.load_slam`` continues the JAX run under the
pipeline's ATE gate (0.05 m, tests/test_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu.utils import checkpoint as jck
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM
from sadvio_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

RESUME_TOL_M = 1e-6
ATE_TOL_M = 0.05
SPLIT = 12
CFG = SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=1.0, min_movement_parallax=0.02, global_map=True,
                 caps=Capacities(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))


def _port(world, cfg=CFG):
    return TSLAM(from_numpy(jax.tree.map(np.asarray, world.rig), "cpu"), cfg, device="cpu")


def _kf_frame(world, slam):
    """The frame of the newest keyframe: its pyramids are the tracking
    template, which a checkpoint does not hold."""
    return next(f for f in world.frames if f.ts == slam.kf_ts[-1])


def _positions(slam):
    return np.asarray([t for _, _, t in slam.traj])


@pytest.fixture(scope="module")
def world():
    return jsyn.make_world(seed=9, n_frames=24, width=320, height=240, n_points=200)


@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """A port run and a JAX run over the first SPLIT frames, each saved."""
    d = tmp_path_factory.mktemp("ckpt")
    ts = _port(world)
    for f in world.frames[:SPLIT]:
        ts.process_frame(f)
    tck.save_slam(str(d / "port.npz"), ts)
    # the saved leaves as the file holds them (ts runs on in a later test)
    leaves = {p: tck._to_file(p, x) for p, x in tck._flatten(tck._device_state(ts))}
    meta = dict(n_kf=ts.n_kf, kf_ts=list(ts.kf_ts), traj=[t for t, _, _ in ts.traj])
    js = JSLAM(world.rig, CFG)
    for f in world.frames[:SPLIT]:
        js.process_frame(f)
    jck.save_slam(str(d / "jax.npz"), js)
    return dict(ts=ts, js=js, port=str(d / "port.npz"), jax=str(d / "jax.npz"),
                port_leaves=leaves, port_meta=meta)


def _jax_paths(state):
    key = lambda k: str(next(getattr(k, a) for a in ("key", "name", "idx") if hasattr(k, a)))
    return [(".".join(key(k) for k in p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]]


@pytest.mark.parametrize("global_map", [False, True])
def test_leaf_order_shapes_and_dtypes_are_jax(world, global_map):
    cfg = dataclasses.replace(CFG, global_map=global_map)
    jl = _jax_paths(jck._device_state(JSLAM(world.rig, cfg)))
    ts = _port(world, cfg)
    tl = [(p, tck._to_file(p, x)) for p, x in tck._flatten(tck._device_state(ts))]
    assert [p for p, _ in tl] == [p for p, _ in jl] == tck.leaf_paths(ts)
    assert [(a.shape, a.dtype) for _, a in tl] == [(a.shape, a.dtype) for _, a in jl]
    assert ("gm.desc" in tck.leaf_paths(ts)) == global_map
    np.testing.assert_array_equal(ts.key, np.asarray(JSLAM(world.rig, cfg).key))


def test_port_resume_continues_the_run(world, saved):
    a = saved["ts"]
    b = _port(world)
    tck.load_slam(saved["port"], b)
    b.kf_pyr = a.kf_pyr  # the tracking template is not in the file
    for f in world.frames[SPLIT:]:
        a.process_frame(f)
        b.process_frame(f)
    np.testing.assert_allclose(_positions(b), _positions(a), atol=RESUME_TOL_M)
    assert b.vi_initialized == a.vi_initialized and b._have_priors == a._have_priors
    assert b.kf_ts == a.kf_ts and len(b.archived_kf) == len(a.archived_kf)
    assert len(b.kf_cov) == len(b.kf_ts)
    np.testing.assert_allclose(np.asarray(b.kf_cov), np.asarray(a.kf_cov), atol=1e-7)
    assert torch.equal(b.global_map_state.src, a.global_map_state.src)


def test_jax_file_loads_into_the_port(world, saved):
    ts = _port(world)
    tck.load_slam(saved["jax"], ts)
    data = np.load(saved["jax"])
    names = sorted((k for k in data.files if k != "meta"), key=lambda s: int(s.split("_")[1]))
    flat = tck._flatten(tck._device_state(ts))
    assert len(flat) == len(names)
    for (path, leaf), name in zip(flat, names):
        np.testing.assert_array_equal(tck._to_file(path, leaf), data[name], err_msg=path)
    js = saved["js"]
    assert ts.lmk_desc.shape == (CFG.caps.L, 256)
    assert ts.n_kf == js.n_kf and ts.kf_ts == js.kf_ts and ts.initialized
    assert [t for t, _, _ in ts.traj] == [t for t, _, _ in js.traj]
    np.testing.assert_array_equal(ts.key, np.asarray(js.key))
    # without the port's generator state the generator is seeded from the key
    g = torch.Generator().manual_seed((int(js.key[0]) << 32) | int(js.key[1]))
    assert torch.equal(ts.gen.get_state(), g.get_state())
    # and the port continues the JAX run
    ts.kf_pyr = ts._pyramids(torch.as_tensor(_kf_frame(world, js).images))
    for f in world.frames[SPLIT:]:
        ts.process_frame(f)
    assert tsyn.ate_rmse(_positions(ts), world.gt_t) < ATE_TOL_M


def test_port_file_loads_into_the_jax_package(world, saved):
    js = JSLAM(world.rig, CFG)
    jck.load_slam(saved["port"], js)
    leaves = saved["port_leaves"]
    for path, a in _jax_paths(jck._device_state(js)):
        np.testing.assert_array_equal(a, leaves[path], err_msg=path)
        assert a.dtype == leaves[path].dtype, path
    meta = saved["port_meta"]
    assert js.n_kf == meta["n_kf"] and js.kf_ts == meta["kf_ts"]
    assert [t for t, _, _ in js.traj] == meta["traj"]
    js.kf_pyr = js._pyramids(jnp.asarray(_kf_frame(world, js).images))
    for f in world.frames[SPLIT:]:
        js.process_frame(f)
    assert len(js.traj) == len(world.frames)
    assert jsyn.ate_rmse(_positions(js), world.gt_t) < ATE_TOL_M


def test_pre_src_file_still_loads(world, saved, tmp_path):
    """A file saved before GlobalMap gained its ``src`` leaf: the leaf is
    spliced in as full(-1) (no provenance)."""
    data = np.load(saved["port"])
    names = sorted((k for k in data.files if k != "meta"), key=lambda s: int(s.split("_")[1]))
    pos = list(saved["port_leaves"]).index("gm.src")
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, *[data[n] for i, n in enumerate(names) if i != pos],
                        meta=data["meta"])
    ts = _port(world)
    tck.load_slam(old, ts)
    assert bool((ts.global_map_state.src == -1).all())
    np.testing.assert_array_equal(ts.global_map_state.pos.numpy(),
                                  saved["port_leaves"]["gm.pos"])
    assert ts.n_kf == saved["port_meta"]["n_kf"]
