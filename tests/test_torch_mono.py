"""The port's monocular VO (``MonoSLAM``, slam_mode "mono") against the JAX
package's, end to end.

World and config of tests/test_pipeline.py::test_mono_tracks_trajectory:
seed 3, 40 frames, 320x240, camera 0 only, K=6, L=160, P=24,
``boot_parallax_deg=2.0``.  The JAX run goes once per module; the port runs
on the CPU on the JAX world's numpy frames, with the JAX package's essential
RANSAC draws of the bootstrap handed to it (the two packages draw from
different generators).

Gates: those of the JAX test (bootstrap fires, Sim3 ATE of the
post-bootstrap segment < 0.08 m); the bootstrap on the same frame as the
JAX run; keyframe count within 1.  Tolerance: after Sim3-aligning the port's
post-bootstrap positions to the JAX run's, they agree within 5 mm RMS
(measured 0.6 mm: float32 sums in another order; the monocular gauge turns
a small difference at the bootstrap into a scale difference, which the Sim3
alignment absorbs).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.data.window import Rig as JRig
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.mono import MonoSLAM as JMono
from sadvio_tpu_torch.data.convert import from_numpy, pyramid_from_numpy, slam_state_from_numpy
from sadvio_tpu_torch.frontend import epipolar as tep
from sadvio_tpu_torch.pipeline.mono import MonoSLAM as TMono
from tests.test_pipeline import small_config

torch.set_num_threads(2)

SIM3_TOL_M = 0.005
ATE_GATE_M = 0.08


class MonoFrame:
    """Camera 0 of a stereo frame, with its IMU samples."""

    def __init__(self, f):
        self.ts = f.ts
        self.images = f.images[:1]
        self.acc, self.gyr, self.dt = f.acc, f.gyr, f.dt


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def mono_rig(rig):
    return JRig(cam=jax.tree.map(lambda x: x[:1] if hasattr(x, "ndim") and x.ndim > 0 else x,
                                 rig.cam), R_f_s=rig.R_f_s[:1], t_f_s=rig.t_f_s[:1])


@contextlib.contextmanager
def jax_boot_draws(seed=0, skip=0):
    """Hand the port's bootstrap essential RANSAC the JAX package's draws:
    the JAX pipeline splits its key once per bootstrap frame and draws each
    of the 64 hypotheses' 8 indices from a split of that key.  ``skip``:
    bootstrap frames the JAX run already spent its splits on."""
    orig = tep.essential_ransac
    key = [jax.random.PRNGKey(seed)]
    for _ in range(skip):
        key[0] = jax.random.split(key[0])[0]

    def fed(ra, rb, valid, generator=None, **kw):
        key[0], k = jax.random.split(key[0])
        idx = np.stack([np.asarray(jax.random.randint(kk, (8,), 0, ra.shape[0]))
                        for kk in jax.random.split(k, 64)])
        return orig(ra, rb, valid, sample_idx=torch.as_tensor(idx), **kw)

    tep.essential_ransac = fed
    try:
        yield
    finally:
        tep.essential_ransac = orig


def snapshot(js, frame_i):
    """What the port needs to continue a JAX-package MonoSLAM (or
    NoFovSLAM) run after frame ``frame_i``."""
    snap = dict(
        device=_np((js.window, js.obs, js.imu, js.priors, js.tracks, js.pre_cur)),
        cur=_np((js.R_cur, js.t_cur, js.v_cur, js.dT[0], js.dT[1])),
        kf_ts=list(js.kf_ts), n_kf=js.n_kf, have_priors=js._have_priors,
        vi_initialized=js.vi_initialized, vio_init_kfs=js.vio_init_kfs,
        vi_opt_scale=js._vi_opt_scale, kf_pyr=_np(js.kf_pyr), frame_i=frame_i,
        traj=[(ts, np.asarray(R), np.asarray(t)) for ts, R, t in js.traj],
        kf_traj=[(ts, np.asarray(R), np.asarray(t)) for ts, R, t in js.kf_traj],
        archived_kf=[(ts, np.asarray(R), np.asarray(t)) for ts, R, t in js.archived_kf],
        boot=None if js._boot is None else {
            "pyr0": _np(js._boot["pyr0"]), "ts0": js._boot["ts0"],
            **{k: np.asarray(js._boot[k]) for k in ("uv0", "uv", "valid")}})
    if hasattr(js, "scale_state"):
        snap["nofov"] = dict(scale_state=dict(js.scale_state), uv1_last=js.uv1_last.copy(),
                             v1_last=js.v1_last.copy(), uv1_hist=js.uv1_hist.copy(),
                             hist_mask=js.hist_mask.copy(),
                             pyr1_hist=[None if p is None else _np(p) for p in js.pyr1_hist])
    return snap


def load(ts, snap):
    """Put a JAX snapshot into the port's pipeline ``ts`` (CPU)."""
    window, obs, imu, priors, tracks, pre_cur = [from_numpy(x, "cpu") for x in snap["device"]]
    ts.window, ts.obs, ts.imu, ts.priors, ts.tracks, ts.pre_cur = (window, obs, imu, priors,
                                                                   tracks, pre_cur)
    ts.R_cur, ts.t_cur, ts.v_cur, dR, dt = [torch.as_tensor(np.array(x)) for x in snap["cur"]]
    ts.dT = (dR, dt)
    ts.kf_ts, ts.n_kf = list(snap["kf_ts"]), snap["n_kf"]
    ts.kf_cov = [np.zeros((6, 6)) for _ in ts.kf_ts]
    ts._have_priors, ts.vi_initialized = snap["have_priors"], snap["vi_initialized"]
    ts.initialized = True
    ts.traj, ts.kf_traj = list(snap["traj"]), list(snap["kf_traj"])
    ts.archived_kf = list(snap["archived_kf"])
    ts.kf_pyr = tuple(pyramid_from_numpy(p) for p in snap["kf_pyr"])
    ts.kf_tmpl = ts._template_cache(ts.kf_pyr, ts.tracks.uv_kf[0])
    ts._imu_n = 0
    slam_state_from_numpy(ts, boot=snap["boot"], vio_init_kfs=snap["vio_init_kfs"],
                          vi_opt_scale=snap["vi_opt_scale"], **snap.get("nofov", {}))
    return ts


PENDING_BACK = 3  # frames before the bootstrap at which a pending one is kept


def drive(slam, frames, record=None):
    """Run frames; returns (bootstrap frame index, [out], snapshot at the
    bootstrap of a JAX pipeline if ``record``).  With ``record`` the
    snapshot also holds, under "pending", the JAX pipeline's bootstrap state
    and trajectory before frame i0 - PENDING_BACK."""
    i0, outs, snap, before = None, [], None, {}
    for i, f in enumerate(frames):
        if record and not slam.initialized:
            before[i] = (None if slam._boot is None else dict(slam._boot), list(slam.traj))
        outs.append(slam.process_frame(f))
        if i0 is None and slam.initialized:
            i0 = i
            if record:
                snap = snapshot(slam, i)
                boot, traj = before[i - PENDING_BACK]
                snap["pending"] = dict(stop=i - PENDING_BACK, traj=traj, boot=None if boot is None else {
                    "pyr0": _np(boot["pyr0"]), "ts0": boot["ts0"],
                    **{k: np.asarray(boot[k]) for k in ("uv0", "uv", "valid")}})
    return i0, outs, snap


def post_boot(slam, i0):
    return np.asarray([t for _, _, t in slam.traj], np.float64)[i0:]


def record_predictions(slam, log):
    """Log (frame ts, predicted t, vi_initialized) of every prediction."""
    orig = slam._predict_pose

    def wrapped(frame):
        out = orig(frame)
        log.append((frame.ts, np.asarray(out[1]).copy(), slam.vi_initialized))
        return out

    slam._predict_pose = wrapped


def run_pair(mode, imu):
    world = jsyn.make_world(seed=3, n_frames=40, width=320, height=240, n_points=200,
                            imu_noise=True)
    frames = [MonoFrame(f) for f in world.frames]
    rig1 = mono_rig(world.rig)
    cfg = small_config(mode)
    kw = dict(imu_params=world.imu_params) if imu else {}
    js = JMono(rig1, cfg, boot_parallax_deg=2.0, **kw)
    j_pred = []
    record_predictions(js, j_pred)
    j_i0, j_outs, snap = drive(js, frames, record=True)
    trig = from_numpy(_np(rig1), "cpu")
    tkw = dict(imu_params=from_numpy(_np(world.imu_params))) if imu else {}
    ts = TMono(trig, cfg, boot_parallax_deg=2.0, device="cpu", **tkw)
    t_pred = []
    record_predictions(ts, t_pred)
    with jax_boot_draws():
        t_i0, t_outs, _ = drive(ts, frames)
    return dict(world=world, frames=frames, cfg=cfg, trig=trig, tkw=tkw, js=js, ts=ts,
                j_i0=j_i0, t_i0=t_i0, j_outs=j_outs, t_outs=t_outs, snap=snap,
                j_pred=j_pred, t_pred=t_pred)


def check_gates(slam, i0, world):
    assert slam.initialized and i0 is not None, "bootstrap never triggered"
    est = post_boot(slam, i0)
    assert np.isfinite(est).all()
    ate = jsyn.ate_rmse(est, world.gt_t[i0: i0 + len(est)], with_scale=True)
    assert ate < ATE_GATE_M, f"ATE {ate:.4f} m"
    return est


def check_agreement(runs):
    js, ts = runs["js"], runs["ts"]
    assert runs["t_i0"] == runs["j_i0"], (runs["t_i0"], runs["j_i0"])
    n_j = sum(o["is_kf"] for o in runs["j_outs"])
    n_t = sum(o["is_kf"] for o in runs["t_outs"])
    assert abs(n_t - n_j) <= 1, (n_t, n_j)
    ej, et = post_boot(js, runs["j_i0"]), post_boot(ts, runs["t_i0"])
    assert jsyn.ate_rmse(et, ej, with_scale=True) < SIM3_TOL_M


def check_handover(runs):
    """A JAX-package state taken right after its bootstrap continues in the
    port under the same gate."""
    snap = runs["snap"]
    assert snap is not None and snap["n_kf"] == 2 and snap["boot"] is None
    ts = load(TMono(runs["trig"], runs["cfg"], boot_parallax_deg=2.0, device="cpu",
                    **runs["tkw"]), snap)
    assert ts.tracks.uv.shape[0] == 1 and ts._vi_opt_scale and ts.vio_init_kfs == 6
    for f in runs["frames"][snap["frame_i"] + 1:]:
        ts.process_frame(f)
    assert ts.n_resets == 0 and len(ts.traj) == len(runs["frames"])
    check_gates(ts, snap["frame_i"], runs["world"])
    return ts


@pytest.fixture(scope="module")
def runs():
    return run_pair("mono", imu=False)


def test_port_mono_tracks_trajectory(runs):
    check_gates(runs["ts"], runs["t_i0"], runs["world"])
    assert runs["ts"].n_resets == 0
    assert runs["ts"].global_map_state is None


def test_bootstrap_keyframes_and_positions_agree(runs):
    check_agreement(runs)


def test_jax_state_after_bootstrap_continues_in_port(runs):
    check_handover(runs)


def test_pending_bootstrap_carries_over(runs):
    """A JAX MonoSLAM stopped in the middle of its bootstrap (first frame
    detected, tracks pending) finishes the bootstrap in the port on the
    frame the JAX run did."""
    frames = runs["frames"]
    pending = runs["snap"]["pending"]
    stop = pending["stop"]
    assert pending["boot"] is not None
    ts = TMono(runs["trig"], runs["cfg"], boot_parallax_deg=2.0, device="cpu")
    slam_state_from_numpy(ts, boot=pending["boot"])
    ts.traj = [(t, np.asarray(R), np.asarray(p)) for t, R, p in pending["traj"]]
    assert ts._boot["pyr0"][0][0].shape == frames[0].images[0].shape
    with jax_boot_draws(skip=stop - 1):
        for i, f in enumerate(frames[stop:], start=stop):
            ts.process_frame(f)
            if ts.initialized:
                break
    assert ts.initialized and i == runs["j_i0"]
