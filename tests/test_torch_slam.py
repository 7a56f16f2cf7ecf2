"""The port's stereo-VIO pipeline against the JAX package's, end to end.

World and config of tests/test_pipeline.py (seed 3, 40 frames, 320x240,
bimonovio, K=4, L=160, P=24, window rolls).  The JAX StereoSLAM runs once
per module; the port runs on the CPU on the JAX world's numpy frames.

Tolerances: positions agree frame by frame within 1 cm (measured ~2 mm:
the two packages draw different RANSAC hypotheses and sum in another
order, and the difference grows slowly along the run); one backend step
from the same JAX state agrees to 1e-3 m.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.config import SLAMConfig as TSLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM

torch.set_num_threads(2)

POS_TOL_M = 0.01
CFG = SLAMConfig(slam_mode="bimonovio", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=0.5, min_movement_parallax=0.02,
                 marginalization=True, sparsification=True,
                 caps=Capacities(K=4, L=160, P=24, pyr_levels=3, klt_radius=5))


def _record_predictions(slam, log):
    """Wrap _predict_pose to log (frame ts, predicted t, vi_initialized)."""
    orig = slam._predict_pose

    def wrapped(frame):
        out = orig(frame)
        log.append((frame.ts, np.asarray(out[1]).copy(), slam.vi_initialized))
        return out

    slam._predict_pose = wrapped


@pytest.fixture(scope="module")
def runs():
    world = jsyn.make_world(seed=3, n_frames=40, width=320, height=240, n_points=200,
                            imu_noise=True)
    js = JSLAM(world.rig, CFG, imu_params=world.imu_params)
    j_pred, snap = [], None
    _record_predictions(js, j_pred)
    for f in world.frames:
        js.process_frame(f)
        if snap is None and len(js.archived_kf) == 1:
            # the JAX pipeline's state right after its first window roll
            snap = jax.tree.map(np.asarray, (js.window, js.obs, js.imu, js.priors, js.tracks))
    rig = from_numpy(jax.tree.map(np.asarray, world.rig), "cpu")
    ts = TSLAM(rig, CFG, imu_params=from_numpy(jax.tree.map(np.asarray, world.imu_params)),
               device="cpu")
    t_pred = []
    _record_predictions(ts, t_pred)
    ts.run(world.frames)
    return dict(world=world, js=js, ts=ts, snap=snap, j_pred=j_pred, t_pred=t_pred)


def test_port_tracks_with_vio_init_and_rolls(runs):
    ts, world = runs["ts"], runs["world"]
    est = np.asarray([t for _, _, t in ts.traj])
    assert len(est) == len(world.frames) and np.isfinite(est).all()
    assert ts.vi_initialized
    assert len(ts.archived_kf) >= 1, "window never rolled"
    assert bool(ts.priors.sp_mask.any()), "sparsified VIO state prior missing"
    assert bool(ts.priors.plp_mask.any())
    assert tsyn.ate_rmse(est, world.gt_t) < 0.05
    assert abs(ts.kf_traj[0][1][2, 2]) > 0.95  # gravity-aligned start


def test_positions_agree_frame_by_frame(runs):
    js, ts = runs["js"], runs["ts"]
    pj = np.asarray([t for _, _, t in js.traj])
    pt = np.asarray([t for _, _, t in ts.traj])
    d = np.linalg.norm(pj - pt, axis=1)
    assert d.max() < POS_TOL_M, (d.max(), d.argmax())
    assert [ts_ for ts_, _, _ in ts.kf_traj] == [ts_ for ts_, _, _ in js.kf_traj]
    assert len(ts.archived_kf) == len(js.archived_kf)


def test_backend_and_roll_from_jax_state(runs):
    """Start the port from the JAX state after its first roll and run one
    backend + marginalization roll in both packages."""
    js, ts, snap = runs["js"], runs["ts"], runs["snap"]
    assert snap is not None
    window, obs, imu, priors, tracks = snap
    jw, jo, _ = js._backend(window, obs, imu, priors, 0)
    tw, to, _ = ts._backend(*[from_numpy(x) for x in (window, obs, imu, priors)], 0)
    np.testing.assert_allclose(tw.t.numpy(), np.asarray(jw.t), atol=1e-3)
    np.testing.assert_allclose(tw.R.numpy(), np.asarray(jw.R), atol=1e-3)
    np.testing.assert_array_equal(tw.lmk_mask.numpy(), np.asarray(jw.lmk_mask))
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))

    j_in = jax.tree.map(np.asarray, (jw, jo))
    jr = js._marg_roll(*j_in, imu, priors, tracks, True)
    tr = ts._marg_roll(*[from_numpy(x) for x in (*j_in, imu, priors, tracks)], True)
    jwin, jpri, twin, tpri = jr[0], jr[3], tr[0], tr[3]
    np.testing.assert_allclose(twin.t.numpy(), np.asarray(jwin.t), atol=1e-6)
    for name in ("prior_slots", "prior_slot_mask", "sp_mask", "plp_mask", "plp_frame"):
        np.testing.assert_array_equal(getattr(tpri, name).numpy(), np.asarray(getattr(jpri, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(twin.lmk_mask.numpy(), np.asarray(jwin.lmk_mask))
    np.testing.assert_array_equal(tr[1].mask.numpy(), np.asarray(jr[1].mask))


def test_pre_vi_init_prediction_is_constant_velocity(runs):
    """Deviation from the JAX package (logged in ROADMAP queue C): before
    VIInit the window velocity is still zero, and the JAX package's IMU
    prediction from it lags the motion by v * dt.  The port predicts with
    the constant-velocity model until VIInit has run."""
    est_j = {ts_: t for ts_, _, t in runs["js"].traj}
    est_t = {ts_: t for ts_, _, t in runs["ts"].traj}
    # from the second tracked frame on, when the constant-velocity model
    # has seen one motion
    err_j = [np.linalg.norm(p - est_j[k]) for k, p, vi in runs["j_pred"][1:] if not vi]
    err_t = [np.linalg.norm(p - est_t[k]) for k, p, vi in runs["t_pred"][1:] if not vi]
    assert err_j and err_t
    assert max(err_t) < 0.01
    assert max(err_j) > 3 * max(err_t)


def test_unported_config_keys_raise(runs):
    rig = runs["ts"].rig
    # the mono modes belong to MonoSLAM and NoFovSLAM, not to StereoSLAM
    for change in (dict(slam_mode="mono"),
                   dict(slam_mode="nofov"), dict(tracker="other"), dict(pose_estimator="imu")):
        with pytest.raises(NotImplementedError, match=next(iter(change))):
            TSLAM(rig, dataclasses.replace(TSLAMConfig(), **change), device="cpu")
    # the keys of the long-run path, the matcher/epipolar front end, the
    # other marginalization forms, the angular optimizer, the back end on
    # a second stream and the one-frame-late health harvest are accepted
    for change in (dict(tracker="matcher"), dict(pose_graph=True), dict(global_map=True),
                   dict(marg_f64=True), dict(sparsification=False), dict(mesh3d=True),
                   dict(pose_estimator="epipolar"), dict(optimizer="angularanalytic"),
                   dict(multithreading=True), dict(async_health=True)):
        TSLAM(rig, dataclasses.replace(TSLAMConfig(), **change), device="cpu")
    # run(profile=True) is ported: no frames give an empty trajectory
    fresh = TSLAM(rig, TSLAMConfig(), device="cpu")
    assert fresh.run([], profile=True).shape == (0,)
    assert fresh._prof is not None and not fresh._prof.counts


def test_corrupt_frames_trigger_reset(runs):
    """Blank images: the port dead-reckons, resets after more than 5
    consecutive PnP failures, emits no non-finite pose, and bootstraps
    again on good frames."""
    world = runs["world"]
    ts = TSLAM(runs["ts"].rig, CFG, imu_params=runs["ts"].imu_params, device="cpu")
    for f in world.frames[:8]:
        ts.process_frame(f)
    assert ts.initialized
    blank = world.frames[8]._replace(images=np.zeros_like(world.frames[8].images))
    for _ in range(10):
        ts.process_frame(blank)
    assert ts.n_resets >= 1
    assert all(np.isfinite(t).all() for _, _, t in ts.traj)
    for f in world.frames[9:14]:
        out = ts.process_frame(f)
    assert ts.initialized and out["ok"]
