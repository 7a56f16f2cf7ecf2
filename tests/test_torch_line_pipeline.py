"""The port's StereoSLAM with the linexd channel in the window BA against
the JAX package's, on tests/test_line_e2e.py's point-starved world (seed 7,
24 frames, 320x240, 20 blobs, 12 bright 3D segments).

One JAX line run and one JAX point-only run per module; the port runs the
same frames with lines, without lines, and from the JAX line run's state
(line channel included) handed over at its first keyframe after frame 12.
The port's line runs get the JAX run's PnP RANSAC draws (the key chain of
its frame loop).

Gates, each run against its own package's point-only run (for the handed
over run: the JAX one, whose first half it shares): the JAX test's (>= 6
lines and >= 5 tracked at the last keyframe, >= 5 lines in the BA block,
line ATE < 0.9 x point-only ATE, the best half of the line map within
0.5 m of a true line), and the handed-over run keeps the JAX run's
keyframes.

The two packages' runs are not compared frame by frame: most tracks of
this world sit on line edges, where the KLT solution along the edge is
ill-posed, and float32 rounding moves it by up to 0.1 px and flips
forward-backward gates.  From the same frame-0 state the point-only runs
already part by 5 mm at frame 1 and keyframe a frame apart at frame 6.
Instead one keyframe's line update and line-constrained window BA are
compared from the same JAX state: the update's slots, masks and block
identical, its endpoints within 1e-4 m; after the BA poses within 1e-3 m
(measured 5.4e-4 m) and cost within 1e-2 relative (measured 1.2e-3), the
same observation masks, and line endpoints within 2 cm of the JAX lines
across them (measured 7.5 mm).  The state comes from a converged BA, so
its gradient is float noise, and the two LM runs accept different steps
(their first steps differ by 0.3%); along a line, where the segment extent
is weakly observed, the endpoints part by up to 3.7 cm.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sadvio_tpu.pipeline.channels  # noqa: F401  (before any trace: it builds bbox.CUBE)
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, FeatureConfig, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.data.convert import from_numpy, pyramid_from_numpy, slam_state_from_numpy
from sadvio_tpu_torch.frontend import pnp as tpnp
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM

torch.set_num_threads(2)

HANDOVER_AFTER = 12
CFG = SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=1.0, min_movement_parallax=0.02,
                 features=(FeatureConfig(), FeatureConfig(label="linexd")),
                 caps=Capacities(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_draws = jax.jit(lambda k, n: jax.vmap(lambda kk: jax.random.randint(kk, (4,), 0, n))(
    jax.random.split(k, 48)), static_argnums=1)


@contextlib.contextmanager
def jax_pnp_draws(ts, key):
    """Give the port's frame-rate PnP the JAX run's hypotheses: the JAX
    pipeline splits its key once per frame track (PnP draws from the first
    half) and once per keyframe insertion, starting from ``key``."""
    state = {"key": key}
    orig_pnp, orig_ins = tpnp.pnp_ransac, ts._insert_kf

    def pnp_fed(cam, Rfs, tfs, p_w, uv, valid, R_pred, t_pred, generator=None, **kw):
        k, state["key"] = jax.random.split(state["key"])
        idx = torch.as_tensor(np.asarray(_draws(k, p_w.shape[0])))
        kw.pop("sample_idx", None)  # the port's own draws, replaced by the JAX run's
        return orig_pnp(cam, Rfs, tfs, p_w, uv, valid, R_pred, t_pred, sample_idx=idx, **kw)

    def insert_fed(*a, **kw):
        state["key"] = jax.random.split(state["key"])[1]
        return orig_ins(*a, **kw)

    tpnp.pnp_ransac, ts._insert_kf = pnp_fed, insert_fed
    try:
        yield
    finally:
        tpnp.pnp_ransac = orig_pnp
        del ts._insert_kf


LINE_FIELDS = ("p0", "p1", "mask", "age", "obs_ends", "obs_mask", "obs_R", "obs_t")


def _snapshot(js):
    ch = js._line_ch
    return dict(
        device=_np((js.window, js.obs, js.imu, js.priors, js.tracks, js.pre_cur)),
        cur=_np((js.R_cur, js.t_cur, js.v_cur, js.dT[0], js.dT[1])),
        kf_ts=list(js.kf_ts), n_kf=js.n_kf, have_priors=js._have_priors,
        kf_pyr=_np(js.kf_pyr), kf_cov=[np.array(c) for c in js.kf_cov], key=js.key,
        traj=list(js.traj), kf_traj=list(js.kf_traj), archived_kf=list(js.archived_kf),
        line={k: np.asarray(getattr(ch, k)) for k in LINE_FIELDS} | {"_head": ch._head})


def _load(ts, snap):
    (ts.window, ts.obs, ts.imu, ts.priors, ts.tracks, ts.pre_cur) = [
        from_numpy(x, "cpu") for x in snap["device"]]
    ts.R_cur, ts.t_cur, ts.v_cur, dR, dt = [torch.as_tensor(np.array(x)) for x in snap["cur"]]
    ts.dT = (dR, dt)
    ts.kf_ts, ts.n_kf, ts._have_priors = list(snap["kf_ts"]), snap["n_kf"], snap["have_priors"]
    ts.kf_cov = list(snap["kf_cov"])
    ts.initialized = True
    ts.traj, ts.kf_traj, ts.archived_kf = (list(snap["traj"]), list(snap["kf_traj"]),
                                           list(snap["archived_kf"]))
    ts.kf_pyr = tuple(pyramid_from_numpy(p) for p in snap["kf_pyr"])
    ts.kf_tmpl = ts._template_cache(ts.kf_pyr, ts.tracks.uv_kf[0])
    slam_state_from_numpy(ts, channels=[snap["line"]])
    return ts


@pytest.fixture(scope="module")
def runs():
    world = jsyn.make_world(seed=7, n_frames=24, width=320, height=240, n_points=20, n_lines=12,
                            imu_noise=False)
    js = JSLAM(world.rig, CFG)
    j_outs, snap = [], None
    for i, f in enumerate(world.frames):
        j_outs.append(js.process_frame(f))
        if snap is None and i >= HANDOVER_AFTER and j_outs[-1]["is_kf"]:
            snap = (i, _snapshot(js))
    ate_jax_points = jsyn.ate_rmse(
        JSLAM(world.rig, dataclasses.replace(CFG, features=(FeatureConfig(),))).run(world.frames),
        world.gt_t)
    rig = from_numpy(jax.tree.map(np.asarray, world.rig), "cpu")
    ts = TSLAM(rig, CFG, device="cpu")
    with jax_pnp_draws(ts, jax.random.PRNGKey(0)):
        t_outs = [ts.process_frame(f) for f in world.frames]
    tp = TSLAM(rig, dataclasses.replace(CFG, features=(FeatureConfig(),)), device="cpu")
    tp.run(world.frames)
    i0, s = snap
    th = _load(TSLAM(rig, CFG, device="cpu"), s)
    with jax_pnp_draws(th, s["key"]):
        h_outs = [th.process_frame(f) for f in world.frames[i0 + 1:]]
    return dict(world=world, js=js, j_outs=j_outs, ts=ts, t_outs=t_outs, tp=tp, th=th,
                h_outs=h_outs, i0=i0, snap=s, ate_jax_points=ate_jax_points)


def _positions(slam):
    return np.asarray([t for _, _, t in slam.traj])


def _gates(slam, outs, world, ate_points):
    kf_outs = [o for o in outs if o.get("is_kf") and "n_lines" in o]
    assert kf_outs and kf_outs[-1]["n_lines"] >= 6, kf_outs
    assert kf_outs[-1]["n_lines_tracked"] >= 5, kf_outs
    assert int(slam._line_ch.ba_block().mask.sum()) >= 5
    ate = tsyn.ate_rmse(_positions(slam), world.gt_t)
    assert ate < 0.9 * ate_points, (ate, ate_points)

    def pld(p, a, b):
        d = (b - a) / np.linalg.norm(b - a)
        r = p - a
        return np.linalg.norm(r - (r @ d) * d)

    errs = sorted(min(max(pld(s[0], g[0], g[1]), pld(s[1], g[0], g[1])) for g in world.segments)
                  for s in slam._line_ch.segments())
    assert errs[len(errs) // 2] < 0.5, errs


def test_port_line_run_passes_the_jax_gates(runs):
    world, ts, tp = runs["world"], runs["ts"], runs["tp"]
    assert ts._line_ch is not None and ts._line_ch.obs_mask.device.type == "cpu"
    _gates(ts, runs["t_outs"], world, tsyn.ate_rmse(_positions(tp), world.gt_t))


def test_keyframe_line_update_and_ba_from_jax_state(runs):
    """From the handed-over JAX state: the line channel's pre-BA update at
    the keyframe's slot (its images and pose again) and the window BA with
    the line block, in both packages."""
    from sadvio_tpu.pipeline.line_channel import LineChannel as JLineChannel

    js, s, world = runs["js"], runs["snap"], runs["world"]
    th = _load(TSLAM(from_numpy(jax.tree.map(np.asarray, world.rig), "cpu"), CFG, device="cpu"),
               s)
    jc = JLineChannel(world.rig, in_ba=True, k_window=CFG.caps.K)
    for k in LINE_FIELDS:
        setattr(jc, k, jnp.asarray(s["line"][k]))
    jc._head = s["line"]["_head"]
    jw, jo, jimu, jpri = [jax.tree.map(jnp.asarray, x) for x in s["device"][:4]]
    slot = s["n_kf"] - 1
    imgs = world.frames[runs["i0"]].images
    hj = jc.on_keyframe_pre_ba(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jw.R[slot],
                               jw.t[slot], slot)
    ht = th._line_ch.on_keyframe_pre_ba(torch.as_tensor(imgs[0]), torch.as_tensor(imgs[1]),
                                        th.window.R[slot], th.window.t[slot], slot)
    assert ht == hj
    bj, bt = jc.ba_block(), th._line_ch.ba_block()
    for k in ("mask", "probation", "obs_mask"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(), np.asarray(getattr(bj, k)), k)
    np.testing.assert_allclose(bt.ends.numpy(), np.asarray(bj.ends), atol=1e-4)
    assert int(bt.mask.sum()) >= 5
    ww, wo, stj = js._backend(jw, jo, jimu, jpri, 0, bj)
    tw, to, stt = th._backend(th.window, th.obs, th.imu, th.priors, 0, bt)
    np.testing.assert_allclose(tw.t.numpy(), np.asarray(ww.t), atol=1e-3)
    np.testing.assert_allclose(tw.R.numpy(), np.asarray(ww.R), atol=1e-3)
    assert abs(float(stt["cost"]) - float(stj["cost"])) < 1e-2 * float(stj["cost"])
    np.testing.assert_array_equal(stt["line_obs_mask"].numpy(), np.asarray(stj["line_obs_mask"]))
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(wo.mask))
    ej, et = np.asarray(stj["line_ends"]), stt["line_ends"].numpy()
    m = np.asarray(bj.mask)
    d = ej[m, 1] - ej[m, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    diff = et[m] - ej[m]
    across = diff - (diff * d[:, None]).sum(-1, keepdims=True) * d[:, None]
    assert np.linalg.norm(across, axis=-1).max() < 0.02
    np.testing.assert_array_equal(et[~m], ej[~m])  # lines outside the BA stay put


def test_handed_over_jax_state_finishes_under_the_gates(runs):
    js, th, world = runs["js"], runs["th"], runs["world"]
    assert runs["i0"] >= HANDOVER_AFTER and len(th.traj) == len(world.frames)
    _gates(th, runs["j_outs"][: runs["i0"] + 1] + runs["h_outs"], world, runs["ate_jax_points"])
    assert [t for t, _, _ in th.kf_traj] == [t for t, _, _ in js.kf_traj]
