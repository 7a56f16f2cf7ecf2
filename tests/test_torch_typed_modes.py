"""Typed feature labels in the monocular and nofov pipelines, against the
JAX package.

The typed channels are built by ``StereoSLAM``'s ``features_handled``
dispatch, which both packages run in their mono subclasses with the rig's
camera count: with one camera only ``ellipsepatternxd`` builds (linexd,
edgeletxd and bboxxd need two), and the csv point detector is accepted and
unused (the monocular keyframe insertion detects its own points).

* mono: the world of tests/test_torch_mono.py (seed 3, 40 frames, camera 0,
  K=6, L=160) with a coded pattern (ID 9, side 1 m) stamped on camera 0, as
  tests/test_channels.py stamps it, and every label in the config.  Gates:
  the JAX mono test's (Sim3 ATE < 0.08 m); the bootstrap on the same frame
  and the keyframe count within 1, as tests/test_torch_mono.py holds them;
  the same pattern IDs in both packages' channels.
* nofov: the world of tests/test_torch_nofov_pipeline.py (seed 6, 320x240,
  lever 1.5 m), 30 frames, every label.  Keyframes on the same frames and
  positions within 1 cm (tests/test_torch_slam.py's bound).  Reference
  fault (ROADMAP queue C): the two cameras share no view, so the stereo
  channels (lines, edgelets, boxes) run at every keyframe and never hold
  anything, in both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, FeatureConfig, SLAMConfig
from sadvio_tpu.pipeline.mono import MonoSLAM as JMono
from sadvio_tpu.pipeline.nofov_mode import NoFovSLAM as JNoFov
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline.mono import MonoSLAM as TMono
from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM as TNoFov
from tests.test_channels import _stamp_pattern
from tests.test_pipeline import small_config
from tests.test_torch_mono import (
    MonoFrame, check_agreement, check_gates, drive, jax_boot_draws, mono_rig,
)

torch.set_num_threads(2)

POS_TOL_M = 0.01
NOFOV_FRAMES = 30
ANCHOR = np.array([1.2, 0.6, 5.0])
CORNERS = [ANCHOR, ANCHOR + [-1.0, 0.0, 0.0], ANCHOR + [0.0, -1.0, 0.0],
           ANCHOR + [-1.0, -1.0, 0.0]]
LABELS = ("linexd", "edgeletxd", "ellipsepatternxd", "bboxxd")
STEREO_CHANNELS = ("LineChannel", "EdgeletChannel", "BBoxChannel")


def _features(csv_folder):
    return (FeatureConfig(),) + tuple(FeatureConfig(label=lb, pattern_side=1.0)
                                      for lb in LABELS) + (
        FeatureConfig(label="pointxd", detector="csv", folder=str(csv_folder)),)


def _names(slam):
    return [type(c).__name__ for c in slam.channels]


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    world = jsyn.make_world(seed=3, n_frames=40, width=320, height=240, n_points=200,
                            imu_noise=True)
    cam0 = jax.tree.map(lambda x: x[0] if np.ndim(x) > 0 else x, world.rig.cam)
    frames = []
    for i, f in enumerate(world.frames):
        img = _stamp_pattern(f.images[0], cam0, world.gt_R[i], world.gt_t[i], world.rig,
                             CORNERS, 1.0, pattern_id=9)
        frames.append(MonoFrame(f._replace(images=img[None])))
    cfg = dataclasses.replace(small_config("mono"),
                              features=_features(tmp_path_factory.mktemp("csv")))
    rig1 = mono_rig(world.rig)
    js = JMono(rig1, cfg, boot_parallax_deg=2.0)
    j_i0, j_outs, _ = drive(js, frames)
    ts = TMono(from_numpy(jax.tree.map(np.asarray, rig1), "cpu"), cfg, boot_parallax_deg=2.0,
               device="cpu")
    with jax_boot_draws():
        t_i0, t_outs, _ = drive(ts, frames)
    return dict(world=world, js=js, ts=ts, j_i0=j_i0, t_i0=t_i0, j_outs=j_outs, t_outs=t_outs)


def test_mono_builds_the_jax_channels_and_tracks(mono):
    js, ts = mono["js"], mono["ts"]
    assert _names(ts) == _names(js) == ["EllipseChannel"]
    assert ts._use_csv and js._use_csv and ts._line_ch is None
    check_gates(ts, mono["t_i0"], mono["world"])
    check_agreement(mono)
    pid_t = sorted(ts.channels[0].patterns()[0].tolist())
    pid_j = sorted(np.asarray(js.channels[0].patterns()[0]).tolist())
    assert pid_t == pid_j and 9 in pid_t, (pid_t, pid_j)
    n_t = [o["n_patterns"] for o in mono["t_outs"] if "n_patterns" in o]
    n_j = [o["n_patterns"] for o in mono["j_outs"] if "n_patterns" in o]
    assert n_t and max(n_t) == max(n_j) >= 1


@pytest.fixture(scope="module")
def nofov(tmp_path_factory):
    world = jsyn.make_nofov_world(seed=6, n_frames=NOFOV_FRAMES, width=320, height=240,
                                  n_points=200, rot_scale=1.5, lever=1.5)
    cfg = SLAMConfig(slam_mode="nofov", max_kf_number=5, min_lmk_number=25,
                     max_movement_parallax=0.5, min_movement_parallax=0.02,
                     features=_features(tmp_path_factory.mktemp("csv")),
                     caps=Capacities(K=6, L=320, P=24, pyr_levels=3, klt_radius=5))
    js = JNoFov(world.rig, cfg, boot_parallax_deg=1.5)
    j_outs = [js.process_frame(f) for f in world.frames]
    ts = TNoFov(from_numpy(jax.tree.map(np.asarray, world.rig), "cpu"), cfg,
                boot_parallax_deg=1.5, device="cpu")
    with jax_boot_draws():
        t_outs = [ts.process_frame(f) for f in world.frames]
    return dict(world=world, js=js, ts=ts, j_outs=j_outs, t_outs=t_outs)


def test_nofov_builds_every_channel_and_matches_jax(nofov):
    js, ts = nofov["js"], nofov["ts"]
    assert _names(ts) == _names(js) == ["LineChannel", "EdgeletChannel", "EllipseChannel",
                                        "BBoxChannel"]
    kf = lambda outs: [i for i, o in enumerate(outs) if o["is_kf"]]
    assert kf(nofov["t_outs"]) == kf(nofov["j_outs"]) and len(kf(nofov["t_outs"])) >= 4
    pj = np.asarray([t for _, _, t in js.traj])
    pt = np.asarray([t for _, _, t in ts.traj])
    assert pt.shape == pj.shape == (NOFOV_FRAMES, 3) and ts.n_resets == 0
    assert np.linalg.norm(pj - pt, axis=1).max() < POS_TOL_M
    keys = lambda outs: sorted({k for o in outs for k in o})
    assert keys(nofov["t_outs"]) == keys(nofov["j_outs"])


def test_nofov_stereo_channels_hold_nothing_reference_fault(nofov):
    """Queue C: the C >= 2 rule builds the stereo channels on a rig whose
    cameras look opposite ways; each keyframe runs them, and they never
    triangulate anything, in the JAX package as in the port."""
    js, ts = nofov["js"], nofov["ts"]
    n_kf = sum(o["is_kf"] for o in nofov["t_outs"])
    for outs in (nofov["t_outs"], nofov["j_outs"]):
        for key in ("n_lines", "n_edgelets", "n_boxes"):
            vals = [o[key] for o in outs if key in o]
            assert len(vals) >= n_kf - 2 and max(vals) == 0, (key, vals)
    for slam in (ts, js):
        for ch in slam.channels:
            if type(ch).__name__ in STEREO_CHANNELS:
                assert not bool(np.asarray(ch.mask).any())
