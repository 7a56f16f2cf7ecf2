"""The port's monocular VIO (``MonoSLAM``, slam_mode "monovio") against the
JAX package's, end to end.

World, config, gates and tolerances of tests/test_torch_mono.py, with the
IMU on (tests/test_pipeline2.py::test_monovio_tracks_trajectory): Sim3 ATE
of the post-bootstrap segment < 0.08 m and, once VIInit has fired, the
metric span within 0.7-1.4 of the ground truth's.  At 40 frames the JAX run
makes 3 keyframes and the port 3 or 4, short of ``vio_init_kfs`` = 6, so
VIInit does not fire in either (the on-card smoke run goes 130 frames, where
it does).

How the two differ before VIInit, on purpose (ROADMAP queue C): the JAX
package predicts every frame with the IMU from the window's velocity, which
is still zero, in the bootstrap's gauge (first camera frame, not gravity
aligned, 0.1 m baseline: not metric); the port predicts with the
constant-velocity model until VIInit has run, as it does in the stereo
modes.  The last test pins that (measured: the JAX prediction misses the
pose by up to 206 mm against a 147 mm post-bootstrap span, the port's by
3.6 mm).
"""

import numpy as np
import pytest

from tests.test_torch_mono import (
    check_agreement, check_gates, check_handover, post_boot, run_pair,
)


@pytest.fixture(scope="module")
def runs():
    return run_pair("monovio", imu=True)


def test_port_monovio_tracks_trajectory(runs):
    ts, world = runs["ts"], runs["world"]
    est = check_gates(ts, runs["t_i0"], world)
    assert ts.n_resets == 0 and ts._vi_opt_scale and ts.vio_init_kfs == 6
    if ts.vi_initialized:
        i0 = runs["t_i0"]
        span_gt = np.linalg.norm(world.gt_t[i0 + len(est) - 1] - world.gt_t[i0])
        assert 0.7 < np.linalg.norm(est[-1] - est[0]) / span_gt < 1.4


def test_imu_preintegrated_once_per_sample(runs):
    """The bootstrap pair's IMU factor covers the samples between the two
    keyframes exactly once (tests/test_pipeline2.py's regression guard)."""
    ts, frames = runs["ts"], runs["frames"]
    ts0, ts1 = ts.kf_traj[0][0], ts.kf_traj[1][0]
    n = sum(len(f.dt) for f in frames if ts0 < f.ts <= ts1)
    dt_sum = sum(float(np.sum(f.dt)) for f in frames if ts0 < f.ts <= ts1)
    js = runs["js"]
    assert n > 0
    j_dt = float(np.asarray(js.imu.pre.dt)[0]) if js.n_kf <= js.caps.K - 1 else None
    t_dt = float(ts.imu.pre.dt[0])
    assert t_dt == pytest.approx(dt_sum, rel=1e-5)
    if j_dt is not None:
        assert t_dt == pytest.approx(j_dt, rel=1e-5)


def test_bootstrap_keyframes_and_positions_agree(runs):
    check_agreement(runs)


def test_jax_state_after_bootstrap_continues_in_port(runs):
    ts = check_handover(runs)
    assert ts.vio and bool(ts.imu.mask[0])


def test_pre_vi_init_prediction_is_constant_velocity(runs):
    """Before VIInit the JAX package's IMU prediction from zero velocity in
    the unaligned, unscaled bootstrap gauge misses the pose it then
    estimates by far more than the port's constant-velocity prediction."""
    est_j = {k: t for k, _, t in runs["js"].traj}
    est_t = {k: t for k, _, t in runs["ts"].traj}
    err_j = [np.linalg.norm(p - est_j[k]) for k, p, vi in runs["j_pred"][1:] if not vi]
    err_t = [np.linalg.norm(p - est_t[k]) for k, p, vi in runs["t_pred"][1:] if not vi]
    assert err_j and err_t
    scale = np.linalg.norm(post_boot(runs["ts"], runs["t_i0"])[-1]
                           - post_boot(runs["ts"], runs["t_i0"])[0])
    assert max(err_t) < 0.05 * scale
    assert max(err_j) > 3 * max(err_t)
