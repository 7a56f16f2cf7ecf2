"""The port's sensor-gap paths against the JAX package: the keyframe the
1 s timer forces in VIO, and the IMU factor masked over a gap longer than
1 s (tests/test_config_dispatch.py::test_time_forced_keyframe_vio and
::test_imu_factor_gap_gate, their world and config).

Each scenario runs once in each package on the same frames: the JAX world
(seed 3, 16 frames, 320x240, clean IMU) in bimonovio, then either six
stationary frames 0.4 s apart (the last image again, gravity only on the
accelerometer) or one frame 1.3 s later (a sensor dropout) and a
follow-up 0.3 s after it.  The keyframe decisions and the window's IMU
factor mask are the JAX run's, frame by frame, over the whole dropout
run, and over the stationary run up to its first stationary frame.  There
the JAX run's PnP fails: before VIInit it predicts with the IMU from zero
velocity, which puts the still camera back at the last keyframe's pose,
and the failure forces a keyframe; the port predicts with constant
velocity until VIInit (a standing deviation, ROADMAP), tracks the frame,
and every keyframe of its stationary tail comes from the 1 s timer alone.
"""

import dataclasses
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM
from tests.test_config_dispatch import base_cfg

torch.set_num_threads(2)


def _still(last, R_last, ts, seconds):
    """A frame repeating ``last``'s images at ``ts`` with ``seconds`` of
    still IMU samples at 200 Hz."""
    n = int(round(seconds * 200))
    acc = (R_last.T @ np.array([0.0, 0.0, 9.81])).astype(np.float32)
    return tsyn.FrameData(ts=ts, images=last.images, acc=np.tile(acc, (n, 1)),
                          gyr=np.zeros((n, 3), np.float32),
                          dt=np.full((n,), 1.0 / 200.0, np.float32))


def _tails(world):
    last, R_last = world.frames[-1], world.gt_R[-1]
    return {
        "stationary": [_still(last, R_last, last.ts + 0.4 * i, 0.4) for i in range(1, 7)],
        "dropout": [_still(last, R_last, last.ts + 1.3, 1.3),
                    _still(last, R_last, last.ts + 1.6, 0.3)],
    }


class Step(NamedTuple):
    is_kf: bool
    mask: np.ndarray  # the window's IMU factor mask after the frame
    n_kf: int
    pnp_ok: bool
    kf_ts: float  # the newest keyframe's stamp after the frame


def _drive(slam, frames):
    log = []
    for f in frames:
        out = slam.process_frame(f)
        log.append(Step(bool(out.get("is_kf", False)), np.asarray(slam.imu.mask).copy(),
                        slam.n_kf, bool(out.get("pnp_ok", True)), slam.kf_ts[-1]))
    return log


def _same(t_log, j_log):
    assert [s.is_kf for s in t_log] == [s.is_kf for s in j_log]
    assert [s.n_kf for s in t_log] == [s.n_kf for s in j_log]
    for st, sj in zip(t_log, j_log, strict=True):
        np.testing.assert_array_equal(st.mask, sj.mask)


def _runs(kind):
    world = jsyn.make_world(seed=3, n_frames=16, width=320, height=240, n_points=200,
                            imu_noise=False)
    frames = list(world.frames) + _tails(world)[kind]
    jcfg = dataclasses.replace(base_cfg(), slam_mode="bimonovio")
    js = JSLAM(world.rig, jcfg, imu_params=world.imu_params)
    j_log = _drive(js, frames)
    tcfg = SLAMConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                         if f.name != "caps"}, caps=Capacities(**dataclasses.asdict(jcfg.caps)))
    ts = TSLAM(from_numpy(jax.tree.map(np.asarray, world.rig), "cpu"), tcfg,
               imu_params=from_numpy(jax.tree.map(np.asarray, world.imu_params)), device="cpu")
    t_log = _drive(ts, frames)
    return dict(n0=len(world.frames), frames=frames, js=js, ts=ts, j_log=j_log, t_log=t_log)


@pytest.fixture(scope="module")
def stationary():
    return _runs("stationary")


@pytest.fixture(scope="module")
def dropout():
    return _runs("dropout")


def test_dropout_keyframes_and_imu_masks_match_jax(dropout):
    _same(dropout["t_log"], dropout["j_log"])


def test_stationary_tail_matches_jax_until_the_jax_pnp_fails(stationary):
    t_log, j_log, n0 = stationary["t_log"], stationary["j_log"], stationary["n0"]
    _same(t_log[:n0], j_log[:n0])
    assert not j_log[n0].pnp_ok and j_log[n0].is_kf  # the JAX IMU prediction from v = 0
    assert t_log[n0].pnp_ok and not t_log[n0].is_kf


def test_time_forced_keyframe_vio(stationary):
    """More than 1 s since the last keyframe forces one in VIO with no
    parallax to vote for it (a stationary camera), bounding the
    preintegration interval; that factor's gap is over 1 s too, so it is
    masked (queue C6: the 1 s timer meets the 1 s gap gate)."""
    ts, n0 = stationary["ts"], stationary["n0"]
    t_log = stationary["t_log"]
    assert ts.initialized and ts.n_resets == 0
    frames = stationary["frames"]
    forced = 0
    for i in range(n0, len(frames)):
        due = frames[i].ts - t_log[i - 1].kf_ts > 1.0
        assert t_log[i].is_kf == due, (i, t_log[i])
        assert t_log[i].pnp_ok
        if due:
            forced += 1
            assert not t_log[i].mask[t_log[i].n_kf - 2]
    assert forced >= 1
    assert np.isfinite(ts.t_cur.numpy()).all()


def test_imu_factor_gap_gate(dropout):
    """An inter-keyframe gap over 1 s masks that IMU factor out of the
    window BA; the normal-rate follow-up keeps a finite pose."""
    ts = dropout["ts"]
    gap, _ = dropout["t_log"][dropout["n0"]:]
    assert gap.is_kf  # the gap forces the keyframe
    assert not gap.mask[gap.n_kf - 2], "overlong IMU factor not masked"
    assert gap.mask[: gap.n_kf - 2].any()  # the factors before the gap stay in
    assert np.isfinite(ts.t_cur.numpy()).all()
