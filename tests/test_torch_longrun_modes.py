"""The config keys this slice of the port accepts, each driven end to end on
the CPU on the world of tests/test_pipeline.py (seed 3, 320x240, K=6, L=160):
``mesh3d``, ``tracker: matcher``, ``pose_estimator: epipolar``, ``marg_f64``
and ``sparsification: 0``, then all of the long-run keys together in VIO.

Bounds are those tests/test_pipeline.py asks of the JAX package: ATE under
0.05 m, a cloud of more than 30 points inside the wall's depth band.  The
matcher run is also held against a JAX-package matcher run frame by frame at
1 cm (different RANSAC draws; measured a few mm).
"""

import numpy as np
import pytest
import torch

from sadvio_tpu_torch.pipeline import synthetic
from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM

torch.set_num_threads(2)


def small_config(mode, **kw):
    base = dict(slam_mode=mode, max_kf_number=5, min_lmk_number=25, max_movement_parallax=1.0,
                min_movement_parallax=0.02, marginalization=True, sparsification=True,
                caps=Capacities(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))
    return SLAMConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(seed=3, n_frames=40, width=320, height=240, n_points=200,
                                imu_noise=True, device="cpu")


def _ate(slam, world):
    est = np.asarray([t for _, _, t in slam.traj])
    assert np.isfinite(est).all()
    return synthetic.ate_rmse(est, world.gt_t[: len(est)])


def test_bimono_matcher_tracking_against_jax(world):
    from sadvio_tpu.pipeline.config import Capacities as JCaps, SLAMConfig as JConfig
    from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
    from sadvio_tpu.pipeline import synthetic as jsyn

    jworld = jsyn.make_world(seed=3, n_frames=25, width=320, height=240, n_points=200,
                             imu_noise=True)
    jcfg = JConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                   max_movement_parallax=1.0, min_movement_parallax=0.02, marginalization=True,
                   sparsification=True, tracker="matcher",
                   caps=JCaps(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))
    est_j = JSLAM(jworld.rig, jcfg).run(jworld.frames)
    slam = StereoSLAM(world.rig, small_config("bimono", tracker="matcher"), device="cpu")
    est_t = slam.run(jworld.frames)  # the JAX world's frames, as numpy
    assert _ate(slam, world) < 0.05
    assert len(slam.kf_traj) >= 2
    assert np.abs(est_t - est_j).max() < 0.01


def test_bimono_epipolar_pose_estimator(world):
    """The essential-matrix RANSAC gates the tracks; the frame pose is the
    motion prediction and the keyframe BA corrects it."""
    slam = StereoSLAM(world.rig, small_config("bimono", pose_estimator="epipolar"), device="cpu")
    oks = [slam.process_frame(f).get("pnp_ok", True) for f in world.frames[:25]]
    assert np.mean(oks) > 0.8 and slam.n_resets == 0
    assert _ate(slam, world) < 0.05
    assert len(slam.kf_traj) >= 3


def test_bimono_with_mesh3d(world):
    cfg = small_config("bimono", mesh3d=True, max_length_tsh=2.0, zncc_tsh=0.5)
    slam = StereoSLAM(world.rig, cfg, device="cpu")
    tris = [slam.process_frame(f).get("mesh_triangles") for f in world.frames[:16]]
    assert slam.mesher is not None and max(t for t in tris if t is not None) > 0
    cloud = slam.mesher.dense_points()
    assert len(cloud) > 30
    z = cloud[:, 2]
    assert (np.abs(z - np.clip(z, 3.0, 10.0)) < 1e-6).mean() > 0.9
    assert _ate(slam, world) < 0.05


@pytest.mark.parametrize("mode", ["bimono", "bimonovio"])
@pytest.mark.parametrize("change", [dict(marg_f64=True), dict(sparsification=False),
                                    dict(marg_f64=True, sparsification=False)],
                         ids=["f64", "dense", "f64-dense"])
def test_other_marginalization_forms_end_to_end(world, mode, change):
    # K=4 and a 0.5 deg keyframe vote: the window rolls five times in 40 frames
    cfg = small_config(mode, max_movement_parallax=0.5, **change,
                       caps=Capacities(K=4, L=160, P=24, pyr_levels=3, klt_radius=5))
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device="cpu")
    degen = [slam.process_frame(f).get("marg_degenerate", False) for f in world.frames]
    assert len(slam.archived_kf) >= 2 and not any(degen)
    assert bool(slam.priors.dn_mask) == (not slam.cfg.sparsification)
    if slam.cfg.sparsification:
        assert bool((slam.priors.sp_mask if slam.vio else slam.priors.ll_mask).any())
    assert slam.priors.dn_J.dtype == torch.float32
    assert _ate(slam, world) < 0.05
    if mode == "bimonovio":
        assert slam.vi_initialized


def test_kitchen_sink_vio(world):
    """Marginalization + sparsification + global map + pose graph + mesh in
    VIO, as the soak configuration has them, with a small archive cap."""
    cfg = small_config("bimonovio", global_map=True, pose_graph=True, mesh3d=True,
                       max_length_tsh=2.0, zncc_tsh=0.5, archive_max_nodes=3,
                       max_movement_parallax=0.5,
                       caps=Capacities(K=4, L=160, P=24, pyr_levels=3, klt_radius=5))
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device="cpu")
    for f in world.frames:
        slam.process_frame(f)
    assert slam.vi_initialized and slam.n_resets == 0
    assert 2 <= len(slam.archived_kf) <= 3  # compaction held the cap
    assert len(slam.pose_graph_edges) >= 1
    assert int(slam.global_map_state.src.max()) < len(slam.archived_kf)
    nodes = slam.optimize_archive()
    assert len(nodes) == len(slam.archived_kf) + len(slam.kf_ts)
    assert all(np.isfinite(t).all() for _, _, t in nodes)
    assert len(slam.mesher.dense_points()) > 30
    assert _ate(slam, world) < 0.05
