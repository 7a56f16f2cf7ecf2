"""The port's stereo VIO under a nonzero IMU bias, against the JAX package.

tests/test_pipeline_stress.py's bias world (seed 5, 40 frames, 320x240,
rot_scale 4, gyro bias (0.02, -0.015, 0.01) rad/s, accelerometer bias
(0.05, 0.04, -0.06) m/s^2, noisy IMU) and tests/test_pipeline.py's
small_config.  One JAX run per module, up to its first keyframe after
VIInit; the port runs the same frames twice on the CPU.

* With the JAX package's pre-VIInit motion prediction (the IMU from the
  newest keyframe's velocity, zero before VIInit) the port keeps the JAX
  run's keyframes and VIInit frame and passes the JAX test's gates: VIInit
  fired, ATE < 0.06 m, |bg - true| < 0.01 rad/s, |ba - true| < 0.15 m/s^2.
* As it is (constant velocity until VIInit, a standing deviation) the
  port keeps 108-121 tracks where the JAX run falls to 16, so its fifth
  keyframe, where VIInit first runs, comes at frame 31 instead of a
  starvation keyframe at 29.  There both packages' VIInit solve lands in
  the gravity-tilt valley (|ba| = 1.47 m/s^2, over the 1 m/s^2 plausibility
  gate), the attempt is rejected, and the retry waits for the next
  keyframe, which comes at frame 42, past the world's end: ROADMAP queue
  C8, pinned here.  ATE holds.
* One back-end step from the JAX state at its first keyframe after VIInit:
  the window VI-BA (bias blocks on) and the marginalization roll with the
  VIO state prior (bias rows on), in both packages.  After the BA, poses,
  velocities and both biases within tests/test_torch_backend.py's 1e-4
  (measured <= 2.7e-6); after the roll the window within
  tests/test_torch_slam.py's 1e-6, the prior's masks and slots equal, its
  linearization point (pose, velocity, biases) equal, and the marginal
  information Ak over [kept frame (15, bias rows included), kept
  landmarks] within test_torch_backend.py's 1e-2 relative (measured
  5.3e-5).  The sparsified 15-dof state prior taken from Ak is not
  compared: this window has 120 lonely landmarks, and the JAX package's
  float32 elimination of them turns it into phantom information (its
  diagonal moves between 0.67 and 498 under one-ulp changes of the
  window), while the port's float64 elimination (a standing deviation,
  ROADMAP) keeps it within 1e-2 under the same changes.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.backend import viinit as jvi
from sadvio_tpu.data import window as jwin
from sadvio_tpu.models import imu as jimu
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.backend import viinit as tvi
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.data.window import ImuChain
from sadvio_tpu_torch.models import imu as timu
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM
from sadvio_tpu_torch.utils.struct import tree_map
from tests.test_pipeline import small_config

torch.set_num_threads(2)

GYR_BIAS = np.array([0.02, -0.015, 0.01])
ACC_BIAS = np.array([0.05, 0.04, -0.06])
STATE_TOL = 1e-4  # tests/test_torch_backend.py's ba_solve tolerance
INFO_RTOL = 1e-2  # tests/test_torch_backend.py's marginalization tolerance
VI_BA_GATE = 1.0  # JAX slam.py:_run_vi_init's plausibility gate on |ba|, m/s^2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(obj):
    """The JAX package's container of the same name as a port container."""
    if isinstance(obj, torch.Tensor):
        return jnp.asarray(obj.numpy())
    cls = getattr(jwin, type(obj).__name__, None) or getattr(jimu, type(obj).__name__)
    return cls(**{f.name: _to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def reference_prediction(slam):
    """Give a port pipeline the JAX package's motion prediction: the IMU
    from the newest keyframe's state whenever samples arrived, before VIInit
    too (JAX slam.py:_predict_pose); constant velocity otherwise."""
    own = slam._predict_pose

    def predict(frame):
        if slam._imu_n > 0:
            k, w = slam.n_kf - 1, slam.window
            return timu.predict(slam.pre_cur, w.R[k], w.t[k], w.v[k], ba=w.ba[k], bg=w.bg[k])
        return own(frame)

    slam._predict_pose = predict


def _keep_vi_init_attempts(slam, log):
    """Record what each VIInit attempt was given and what the solve said."""
    own = slam._run_vi_init

    def attempt():
        w, imu = slam.window, slam.imu
        res = tvi.vi_init(w.R, w.t, w.kf_mask, imu, optimize_scale=False, iters=20)
        log.append(dict(n_kf=slam.n_kf, R=w.R.clone(), t=w.t.clone(), kf_mask=w.kf_mask.clone(),
                        imu=imu, converged=bool(res["converged"]), ba=res["ba"].numpy()))
        own()

    slam._run_vi_init = attempt


def _frames_of(outs, key):
    return [i for i, o in enumerate(outs) if o.get(key)]


def _port_slam(world):
    """The port's StereoSLAM on a JAX world, with small_config."""
    cfg = small_config("bimonovio")
    tcfg = SLAMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                         if f.name != "caps"}, caps=Capacities(**dataclasses.asdict(cfg.caps)))
    return TSLAM(from_numpy(_np(world.rig), "cpu"), tcfg,
                 imu_params=from_numpy(_np(world.imu_params)), device="cpu")


@pytest.fixture(scope="module")
def runs():
    world = jsyn.make_world(seed=5, n_frames=40, width=320, height=240, n_points=200,
                            imu_noise=True, rot_scale=4.0, acc_bias=ACC_BIAS, gyr_bias=GYR_BIAS)
    cfg = small_config("bimonovio")
    js = JSLAM(world.rig, cfg, imu_params=world.imu_params)
    j_outs, snap, after_vi = [], None, False
    for f in world.frames:  # up to the first keyframe after VIInit
        j_outs.append(js.process_frame(f))
        if after_vi and j_outs[-1]["is_kf"]:
            snap = _np((js.window, js.obs, js.imu, js.priors, js.tracks))
            break
        after_vi = js.vi_initialized
    out = dict(world=world, js=js, j_outs=j_outs, snap=snap)
    for name in ("reference", "port"):
        ts = _port_slam(world)
        attempts = []
        _keep_vi_init_attempts(ts, attempts)
        if name == "reference":
            reference_prediction(ts)
        out[name] = dict(slam=ts, outs=[ts.process_frame(f) for f in world.frames],
                         attempts=attempts)
    return out


def _bias_errors(slam):
    k = slam.n_kf - 1
    return (float(np.linalg.norm(slam.window.bg[k].numpy() - GYR_BIAS)),
            float(np.linalg.norm(slam.window.ba[k].numpy() - ACC_BIAS)))


def _ate(slam, world):
    est = np.asarray([t for _, _, t in slam.traj])
    assert len(est) == len(world.frames) and np.isfinite(est).all()
    return tsyn.ate_rmse(est, world.gt_t)


def test_reference_prediction_passes_the_jax_gates(runs):
    """The JAX test's gates, and the JAX run's keyframes and VIInit frame."""
    ts, outs, world = runs["reference"]["slam"], runs["reference"]["outs"], runs["world"]
    assert ts.vi_initialized, "VIInit never converged"
    assert ts.n_resets == 0
    assert _ate(ts, world) < 0.06
    bg_err, ba_err = _bias_errors(ts)
    assert bg_err < 0.01, bg_err
    assert ba_err < 0.15, ba_err
    j_outs = runs["j_outs"]
    n = len(j_outs)
    assert _frames_of(outs[:n], "is_kf") == _frames_of(j_outs, "is_kf")
    assert _frames_of(outs[:n], "vi_initialized")[:1] == _frames_of(j_outs, "vi_initialized")[:1]


def test_vio_log_carries_the_estimated_biases(runs, tmp_path):
    """vio_poses.csv's ba / bg columns: zero before VIInit and the newest
    keyframe's estimate after it, in the same rows as the JAX run's log.
    The two runs draw other RANSAC hypotheses and part by up to ~2 cm around
    the JAX run's starvation keyframe: their gyro biases agree within a
    tenth of the JAX test's gate (measured 4.9e-4 rad/s); the accelerometer
    bias is the weakly observed one (the gravity-tilt direction), and each
    run's is within the gate of the truth instead."""
    ts, js = runs["reference"]["slam"], runs["js"]
    ts.write_logs(str(tmp_path))
    rows = np.loadtxt(tmp_path / "vio_poses.csv", delimiter=",", ndmin=2)
    assert rows.shape == (len(runs["world"].frames) - 1, 13)
    np.testing.assert_allclose(rows, np.asarray(ts.vio_log), atol=1e-8)
    np.testing.assert_allclose(rows[-1, 7:10], ts._ba_h, atol=1e-8)
    np.testing.assert_allclose(rows[-1, 10:13], ts._bg_h, atol=1e-8)
    j_rows = np.asarray(js.vio_log)
    n = len(j_rows)
    live = lambda r: np.abs(r[:, 7:]).max(1) > 0
    np.testing.assert_array_equal(live(rows[:n]), live(j_rows))
    assert live(rows[:n]).any() and not live(rows[:n]).all()
    np.testing.assert_allclose(rows[:n, 10:13], j_rows[:, 10:13], atol=1e-3)
    for r in (rows[:n][live(rows[:n])], j_rows[live(j_rows)]):
        assert np.linalg.norm(r[:, 10:13] - GYR_BIAS, axis=1).max() < 0.01
        assert np.linalg.norm(r[:, 7:10] - ACC_BIAS, axis=1).max() < 0.15


def test_vi_init_rejected_at_the_port_cadence_as_in_the_reference(runs):
    """Queue C8: the port as it is keeps its tracks, and its fifth keyframe
    (frame 31) puts VIInit in the gravity-tilt valley; the JAX package's
    solve on the same window says the same, the plausibility gate rejects
    it in both, and no keyframe comes before the world ends."""
    rec, world = runs["port"], runs["world"]
    ts, outs = rec["slam"], rec["outs"]
    assert ts.n_resets == 0
    assert _ate(ts, world) < 0.06
    assert min(o["n_tracked"] for o in outs[1:]) > 90  # the JAX run's falls to 16
    assert _frames_of(outs, "is_kf") == [0, 7, 14, 22, 31]
    (att,) = rec["attempts"]
    assert att["converged"] and np.linalg.norm(att["ba"]) > VI_BA_GATE
    res = jvi.vi_init(jnp.asarray(att["R"].numpy()), jnp.asarray(att["t"].numpy()),
                      jnp.asarray(att["kf_mask"].numpy()), _to_jax(att["imu"]),
                      optimize_scale=False, iters=20)
    assert bool(res["converged"])
    np.testing.assert_allclose(np.asarray(res["ba"]), att["ba"], atol=1e-3)
    assert not ts.vi_initialized
    assert not bool(ts.window.ba.any()) and not bool(ts.window.bg.any())


# The frames of the window's keyframes when VIInit fired (its tenth
# keyframe, frame 106) in chip_smoke.py:phase_stress's biased run: the
# main world (seed 5, 400 blobs, 752x480) with this module's biases and
# rot_scale 4, K=11.  Two of its gaps (44 -> 65, 65 -> 86) are 1.05 s, so
# the pipeline's >1 s gate drops their IMU factors.
MAIN_VI_KEYFRAMES = [0, 7, 15, 23, 32, 44, 65, 86, 97, 106]


@pytest.fixture(scope="module")
def main_vi_world():
    """The main biased world's first 107 frames.  The trajectory and the
    IMU samples do not depend on the image size, so it is rendered at
    64x48."""
    return tsyn.make_world(seed=5, n_frames=MAIN_VI_KEYFRAMES[-1] + 1, width=64, height=48,
                           n_points=400, imu_noise=True, rot_scale=4.0, acc_bias=ACC_BIAS,
                           gyr_bias=GYR_BIAS, device="cpu")


@pytest.mark.parametrize("links", ["every", "gap_gate"])
def test_accelerometer_bias_is_seen_through_the_gravity_tilt(main_vi_world, links):
    """Queue C10: VIInit on the true poses of the main biased run's VIInit
    window and its IMU, in both packages (ba within 1e-3).

    * Every IMU link on: both miss the accelerometer bias by 0.043 m/s^2,
      and that miss is g times the tilt of the gravity direction: along
      gravity's tangent plane a bias and a tilted gravity explain the same
      accelerometer samples, and ten keyframes over 5.3 s do not separate
      them.
    * The links the pipeline's gap gate keeps, as the card run had them:
      both miss by 0.014 m/s^2.  The card run's 0.147 (on its own poses,
      where both packages' solves agree within 1e-5) is ten times that, so
      the poses that VIInit is given set it, not the dropped links."""
    world = main_vi_world
    K, kf = 11, MAIN_VI_KEYFRAMES
    samples = lambda a, b, key: torch.as_tensor(
        np.concatenate([getattr(world.frames[j], key) for j in range(a + 1, b + 1)]))
    zero = torch.zeros(3)
    pres = [timu.preintegrate(samples(a, b, "acc"), samples(a, b, "gyr"), samples(a, b, "dt"),
                              zero, zero, world.imu_params) for a, b in zip(kf[:-1], kf[1:])]
    pres += [timu.Preintegration.identity()] * (K - len(kf))
    on = [links == "every" or world.frames[b].ts - world.frames[a].ts <= 1.0
          for a, b in zip(kf[:-1], kf[1:])]
    assert on.count(False) == (0 if links == "every" else 2)
    chain = ImuChain(pre=tree_map(lambda *xs: torch.stack(xs), *pres),
                     mask=torch.as_tensor(on + [False] * (K - len(kf))))
    R = torch.eye(3).repeat(K, 1, 1)
    t = torch.zeros(K, 3)
    R[:len(kf)] = torch.as_tensor(world.gt_R[kf])
    t[:len(kf)] = torch.as_tensor(world.gt_t[kf])
    kf_mask = torch.arange(K) < len(kf)
    res_t = tvi.vi_init(R, t, kf_mask, chain, optimize_scale=False, iters=20)
    res_j = jvi.vi_init(jnp.asarray(R.numpy()), jnp.asarray(t.numpy()),
                        jnp.asarray(kf_mask.numpy()), _to_jax(chain), optimize_scale=False,
                        iters=20)
    assert bool(res_t["converged"]) and bool(res_j["converged"])
    np.testing.assert_allclose(res_t["ba"].numpy(), np.asarray(res_j["ba"]), atol=1e-3)
    for ba, g_dir in ((res_t["ba"].numpy(), res_t["g_dir"].numpy()),
                      (np.asarray(res_j["ba"]), np.asarray(res_j["g_dir"]))):
        miss = float(np.linalg.norm(ba - ACC_BIAS))
        if links == "gap_gate":
            assert 0.005 < miss < 0.03, miss  # measured 0.0140
            continue
        g_tilt = timu.GRAVITY * float(np.arccos(np.clip(-g_dir[2] / np.linalg.norm(g_dir), -1, 1)))
        assert 0.03 < miss < 0.06, miss  # measured 0.0433
        assert abs(miss - g_tilt) < 0.05 * miss, (miss, g_tilt)


CARD_VI_INIT = Path(__file__).with_name("data") / "card_bias_vi_init.npz"


@pytest.mark.parametrize("links", ["gap_gate", "every"])
def test_card_run_vi_init_agrees_with_the_reference(links):
    """Queue C10 on the card's own inputs: the arguments of the accepted
    VIInit call of chip_smoke.py:phase_stress's biased run (752x480, K=11,
    VIInit at frame 106 on an NVIDIA H100; written by ``chip_smoke.py
    --save-vi-init``).  Both packages' solves agree (ba within 1e-3) and
    miss the accelerometer bias by 0.147 m/s^2 with the links the gap gate
    kept (the run's own 0.1468), 0.141 with every link on: ten times what
    the true poses give (test above), so the visual poses that VIInit is
    given set the miss, in the reference as in the port."""
    z = np.load(CARD_VI_INIT)
    fields = {f.name: torch.as_tensor(z[f"pre_{f.name}"])
              for f in dataclasses.fields(timu.Preintegration)}
    kf_mask = torch.as_tensor(z["kf_mask"])
    n = int(kf_mask.sum())
    mask = torch.as_tensor(z["mask"])
    assert int(mask.sum()) == n - 3  # the two 1.05 s links are off
    if links == "every":
        mask = torch.arange(len(mask)) < n - 1
    chain = ImuChain(pre=timu.Preintegration(**fields), mask=mask)
    R, t = torch.as_tensor(z["R"]), torch.as_tensor(z["t"])
    res_t = tvi.vi_init(R, t, kf_mask, chain, optimize_scale=False, iters=20)
    res_j = jvi.vi_init(jnp.asarray(z["R"]), jnp.asarray(z["t"]), jnp.asarray(z["kf_mask"]),
                        _to_jax(chain), optimize_scale=False, iters=20)
    assert bool(res_t["converged"]) and bool(res_j["converged"])
    np.testing.assert_allclose(res_t["ba"].numpy(), np.asarray(res_j["ba"]), atol=1e-3)
    np.testing.assert_allclose(res_t["bg"].numpy(), np.asarray(res_j["bg"]), atol=1e-4)
    for ba, bg in ((res_t["ba"].numpy(), res_t["bg"].numpy()),
                   (np.asarray(res_j["ba"]), np.asarray(res_j["bg"]))):
        miss = float(np.linalg.norm(ba - ACC_BIAS))
        assert 0.12 < miss < 0.15, miss  # measured 0.1468 (gap gate), 0.1407 (every link)
        assert np.linalg.norm(bg - GYR_BIAS) < 0.01


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _info(W):
    W = np.asarray(W, np.float64)
    return np.swapaxes(W, -1, -2) @ W


def test_backend_and_roll_from_the_jax_state_after_vi_init(runs):
    """One window VI-BA and one marginalization roll with the VIO state
    prior, from the JAX state at its first keyframe after VIInit."""
    from sadvio_tpu.backend import marginalization as jmarg
    from sadvio_tpu_torch.backend import marginalization as tmarg

    js, snap, ts = runs["js"], runs["snap"], runs["reference"]["slam"]
    assert snap is not None, "the JAX run made no keyframe after VIInit"
    window, obs, imu, priors, tracks = snap
    assert np.abs(window.bg).max() > 0.01 and np.abs(window.ba).max() > 0.01  # biases live
    assert np.asarray(imu.mask).any()  # IMU factors in the BA
    jw, jo, _ = js._backend(window, obs, imu, priors, 1)
    tw, to, _ = ts._backend(*[from_numpy(x) for x in (window, obs, imu, priors)], 1)
    for f in ("t", "R", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)),
                                   atol=STATE_TOL, err_msg=f)
    np.testing.assert_array_equal(tw.lmk_mask.numpy(), np.asarray(jw.lmk_mask))
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))

    j_in = _np((jw, jo))
    jr = js._marg_roll(*j_in, imu, priors, tracks, True)
    tr = ts._marg_roll(*[from_numpy(x) for x in (*j_in, imu, priors, tracks)], True)
    jwin, jpri, twin, tpri = jr[0], jr[3], tr[0], tr[3]
    for f in ("t", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(twin, f).numpy(), np.asarray(getattr(jwin, f)),
                                   atol=1e-6, err_msg=f)
    for name in ("prior_slots", "prior_slot_mask", "sp_mask", "plp_mask", "plp_frame"):
        np.testing.assert_array_equal(getattr(tpri, name).numpy(), np.asarray(getattr(jpri, name)),
                                      err_msg=name)
    m = tpri.sp_mask.numpy()
    assert m.any()
    for f in ("sp_t", "sp_R", "sp_v", "sp_bg", "sp_ba"):
        np.testing.assert_array_equal(getattr(tpri, f).numpy()[m], np.asarray(getattr(jpri, f))[m],
                                      err_msg=f)
    np.testing.assert_array_equal(twin.lmk_mask.numpy(), np.asarray(jwin.lmk_mask))
    np.testing.assert_array_equal(tr[1].mask.numpy(), np.asarray(jr[1].mask))

    # the marginal information, and the port's state prior under one-ulp changes
    jw_np, jo_np = j_in
    args = lambda w: (*[from_numpy(x) for x in (w, jo_np)], ts.rig, from_numpy(imu),
                      from_numpy(priors), ts._ba_opts)
    pj, ij = jmarg.marginalize(jw_np, jo_np, js.rig, imu, priors, js._ba_opts, vio=True)
    pt, it = tmarg.marginalize(*args(jw_np), vio=True)
    assert int(it["lonely"].sum()) == int(np.asarray(ij["lonely"]).sum()) > 0
    assert _rel(it["Ak"].numpy(), ij["Ak"]) < INFO_RTOL
    rng = np.random.default_rng(1)
    ulp = lambda x: (x * (1 + rng.choice([-6e-8, 6e-8], x.shape))).astype(np.float32)
    for _ in range(2):
        moved, _ = tmarg.marginalize(*args(jw_np.replace(t=ulp(jw_np.t), lmk=ulp(jw_np.lmk))),
                                     vio=True)
        assert _rel(_info(moved.sp_sqrt_info[1].numpy()), _info(pt.sp_sqrt_info[1].numpy())) \
            < INFO_RTOL
