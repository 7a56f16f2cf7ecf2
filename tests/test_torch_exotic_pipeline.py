"""The port's pipelines on the exotic camera models with the angular
(bearing-vector) window BA, end to end on the CPU.

* Stereo VO on the fisheye, double-sphere and omni rigs with
  ``optimizer: angular`` (tests/test_pipeline_stress.py::
  test_bimono_exotic_camera_angular_ba: seed 13, 30 frames, 320x240, K=6,
  L=160): its gates, at least 3 keyframes and ATE < 0.06 m.  The fisheye run
  is also held against the JAX package's: keyframes on the same frames and
  positions within 1 cm frame by frame (measured ~1 mm: RANSAC draws from
  different generators and float32 sums in another order).
* The monocular presets of configs/ that need them, at test size: omni
  mono with ``angular_analytic`` (sim_omni_mono) and double-sphere monovio
  with ``angular_analytic`` (sim_ds_monovio) on camera 0 of the seed-3
  world: the monocular gate, Sim3 ATE of the post-bootstrap segment
  < 0.08 m.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.mono import MonoSLAM
from sadvio_tpu_torch.pipeline.slam import StereoSLAM
from tests.test_pipeline import small_config
from tests.test_torch_mono import MonoFrame

torch.set_num_threads(2)

POS_TOL_M = 0.01


def _exotic_world(camera):
    return tsyn.make_world(seed=13, n_frames=30, width=320, height=240, n_points=200,
                           imu_noise=False, camera=camera, device="cpu")


@pytest.mark.parametrize("camera", ["fisheye", "double_sphere", "omni"])
def test_bimono_exotic_camera_angular_ba(camera):
    w = _exotic_world(camera)
    cfg = dataclasses.replace(small_config("bimono"), optimizer="angular")
    slam = StereoSLAM(w.rig, cfg, device="cpu")
    assert slam._ba_opts.angular
    assert type(slam.rig.cam).__name__ == {"fisheye": "Fisheye", "omni": "Omni",
                                           "double_sphere": "DoubleSphere"}[camera]
    est = slam.run(w.frames)
    assert len(slam.kf_traj) >= 3 and slam.n_resets == 0
    ate = tsyn.ate_rmse(est, w.gt_t[: len(est)])
    assert ate < 0.06, f"{camera} angular-BA ATE {ate:.4f} m"


def test_fisheye_angular_run_matches_jax():
    wj = jsyn.make_world(seed=13, n_frames=30, width=320, height=240, n_points=200,
                         imu_noise=False, camera="fisheye")
    cfg = dataclasses.replace(small_config("bimono"), optimizer="angular")
    js = JSLAM(wj.rig, cfg)
    js.run(wj.frames)
    ts = StereoSLAM(from_numpy(jax.tree.map(np.asarray, wj.rig), "cpu"), cfg, device="cpu")
    ts.run(wj.frames)
    assert [k for k, _, _ in ts.kf_traj] == [k for k, _, _ in js.kf_traj]
    pj = np.asarray([t for _, _, t in js.traj])
    pt = np.asarray([t for _, _, t in ts.traj])
    assert np.linalg.norm(pj - pt, axis=1).max() < POS_TOL_M


@pytest.mark.parametrize("camera,mode", [("omni", "mono"), ("double_sphere", "monovio")])
def test_mono_exotic_camera_angular_ba(camera, mode):
    w = tsyn.make_world(seed=3, n_frames=40, width=320, height=240, n_points=200,
                        imu_noise=True, camera=camera, device="cpu")
    cfg = dataclasses.replace(small_config(mode), optimizer="angular_analytic")
    slam = MonoSLAM(w.rig.subset([0]), cfg, imu_params=w.imu_params, boot_parallax_deg=2.0,
                    device="cpu")
    assert slam._ba_opts.angular and slam.rig.C == 1
    i0 = None
    for i, f in enumerate(w.frames):
        slam.process_frame(MonoFrame(f))
        if i0 is None and slam.initialized:
            i0 = i
    assert slam.initialized and slam.n_resets == 0
    est = np.asarray([t for _, _, t in slam.traj])[i0:]
    ate = tsyn.ate_rmse(est, w.gt_t[i0: i0 + len(est)], with_scale=True)
    assert ate < 0.08, f"{camera} {mode} ATE {ate:.4f} m"
