"""The port's angular (bearing-vector) and numeric (central-difference) BA
variants against the JAX package's.

Tolerances, with reasons:
* ``angular_residual_jac``: residuals and Jacobians 1e-4 relative to their
  norm (hand Jacobians, float32 on both sides).
* ``reprojection_residual_numeric``: Jacobians 1e-3 relative (central
  differences with eps = 1e-3 of float32 projections: the rounding of
  each difference is ~1e-4 of a pixel over 2e-3).
* Angular window BA on ``__graft_entry__._tiny_problem`` (K=4, L=64, the
  pinhole rig and a fisheye rig), 8-10 LM iterations: poses and landmarks
  1e-4 (m, rad), both runs converge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sadvio_tpu.backend import ba as jba, factors as jfac
from sadvio_tpu.data.window import Observations as JObs, Rig as JRig
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.backend import ba as tba, factors as tfac
from sadvio_tpu_torch.data.convert import from_numpy

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


def _fisheye_rig():
    C = 2
    fe = jcam.Fisheye(fx=jnp.full((C,), 240.0), fy=jnp.full((C,), 240.0),
                      cx=jnp.full((C,), 160.0), cy=jnp.full((C,), 120.0),
                      k1=jnp.full((C,), -0.01), k2=jnp.full((C,), 0.005),
                      k3=jnp.full((C,), -0.002), k4=jnp.full((C,), 0.0005),
                      width=320, height=240)
    return JRig(cam=fe, R_f_s=jnp.broadcast_to(jnp.eye(3), (C, 3, 3)),
                t_f_s=jnp.asarray([[0.0, 0.0, 0.0], [0.11, 0.0, 0.0]], jnp.float32))


def _problem(rig_name, seed=0):
    """The tiny problem on the given rig, observations re-projected exactly,
    then the state perturbed by a seeded draw (slot 0 fixed)."""
    jp = graft._tiny_problem(K=4, C=2, L=64, P=8, seed=seed)
    if rig_name == "fisheye":
        rig = _fisheye_rig()
        uvs, masks = [], []
        for c in range(2):
            cam_c = jax.tree.map(lambda x: x[c] if hasattr(x, "ndim") and x.ndim > 0 else x,
                                 rig.cam)
            uv, v = jcam.project_world(cam_c, jp.state.R[:, None], jp.state.t[:, None],
                                       rig.R_f_s[c], rig.t_f_s[c], jp.state.lmk[None])
            uvs.append(uv)
            masks.append(v)
        jp = jp._replace(rig=rig, obs=JObs(uv=jnp.stack(uvs, 1), mask=jnp.stack(masks, 1)))
    rng = np.random.default_rng(5 + seed)
    dp = (rng.standard_normal((4, 6)) * 0.02).astype(np.float32)
    dp[0] = 0.0
    R, t = jgeo.pose_retract(jp.state.R, jp.state.t, jnp.asarray(dp))
    lmk = jp.state.lmk + jnp.asarray(rng.standard_normal((64, 3)) * 0.05, jnp.float32)
    # vision only: the window BA of a mono or exotic-camera run before VIInit
    jp = jp._replace(state=jp.state.replace(R=R, t=t, lmk=lmk),
                     imu=jp.imu.replace(mask=jnp.zeros_like(jp.imu.mask)))
    p = _np(jp)
    tp = tba.BAProblem(from_numpy(p.state), from_numpy(p.obs), from_numpy(p.rig),
                       from_numpy(p.imu), from_numpy(p.priors),
                       torch.as_tensor(np.array(p.fixed_mask)), bool(p.opt_lmk_only))
    return jp, tp


@pytest.fixture(scope="module")
def chain_inputs():
    """One camera of the fisheye rig, a (K,1,...) pose batch against (1,L,3)
    points, bearing measurements from noisy pixels."""
    jp, tp = _problem("fisheye")
    rng = np.random.default_rng(3)
    cam_j = jax.tree.map(lambda x: x[1] if hasattr(x, "ndim") and x.ndim > 0 else x, jp.rig.cam)
    uv = np.asarray(jp.obs.uv[:, 1]) + rng.standard_normal((4, 64, 2)).astype(np.float32) * 0.7
    args = (jp.state.R[:, None], jp.state.t[:, None], jp.rig.R_f_s[1], jp.rig.t_f_s[1],
            jp.state.lmk[None])
    targs = (tp.state.R[:, None], tp.state.t[:, None], tp.rig.R_f_s[1], tp.rig.t_f_s[1],
             tp.state.lmk[None])
    return cam_j, tp.rig.cam.camera(1), args, targs, uv


def test_angular_residual_jac_matches(chain_inputs):
    cam_j, cam_t, args, targs, uv = chain_inputs
    ray_j = cam_j.backproject(jnp.asarray(uv))
    ray_t = cam_t.backproject(torch.as_tensor(uv))
    sig_j, sig_t = 1.0 / cam_j.focal, 1.0 / cam_t.focal
    rj, Jpj, Jlj, vj = jfac.angular_residual_jac(*args, ray_j, sig_j)
    rt, Jpt, Jlt, vt = tfac.angular_residual_jac(*targs, ray_t, sig_t)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert _rel(rt.numpy(), rj) < 1e-4
    assert _rel(Jpt.numpy(), Jpj) < 1e-4 and _rel(Jlt.numpy(), Jlj) < 1e-4
    # the Jacobian-free form gives the same residual, up to its sign
    # convention (pred - meas against meas - pred)
    r2j, _ = jfac.angular_residual(cam_j, *args, ray_j, sig_j)
    r2t, _ = tfac.angular_residual(cam_t, *targs, ray_t, sig_t)
    assert _rel(r2t.numpy(), r2j) < 1e-4
    np.testing.assert_allclose(r2t.numpy(), -rt.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("rig_name", ["pinhole", "fisheye"])
def test_numeric_residual_matches(rig_name, chain_inputs):
    jp, tp = _problem(rig_name)
    c = 0
    cam_j = jax.tree.map(lambda x: x[c] if hasattr(x, "ndim") and x.ndim > 0 else x, jp.rig.cam)
    args = (jp.state.R[:, None], jp.state.t[:, None], jp.rig.R_f_s[c], jp.rig.t_f_s[c],
            jp.state.lmk[None], jp.obs.uv[:, c], 1.0)
    targs = (tp.state.R[:, None], tp.state.t[:, None], tp.rig.R_f_s[c], tp.rig.t_f_s[c],
             tp.state.lmk[None], tp.obs.uv[:, c], 1.0)
    rj, Jpj, Jlj, vj = jfac.reprojection_residual_numeric(cam_j, *args)
    rt, Jpt, Jlt, vt = tfac.reprojection_residual_numeric(tp.rig.cam.camera(c), *targs)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    m = np.asarray(vj)
    assert _rel(rt.numpy()[m], np.asarray(rj)[m]) < 1e-4
    assert _rel(Jpt.numpy()[m], np.asarray(Jpj)[m]) < 1e-3
    assert _rel(Jlt.numpy()[m], np.asarray(Jlj)[m]) < 1e-3
    # and the differences agree with the analytic chain of the port
    _, Jpa, Jla, _ = tfac.reprojection_residual(tp.rig.cam.camera(c), *targs)
    assert _rel(Jpt.numpy()[m], Jpa.numpy()[m]) < 1e-2
    assert _rel(Jlt.numpy()[m], Jla.numpy()[m]) < 1e-2


@pytest.mark.parametrize("variant", ["angular", "numeric"])
def test_reproj_terms_match(variant):
    """The BA's linearization rows of each variant, masks and weights included."""
    jp, tp = _problem("fisheye")
    jo = jba.BAOptions(**{variant: True})
    to = tba.BAOptions(**{variant: True})
    J = jba._reproj_terms(jp.state, jp.obs, jp.rig, jo)
    T = tba._reproj_terms(tp.state, tp.obs, tp.rig, to)
    np.testing.assert_array_equal(T[3].numpy(), np.asarray(J[3]))
    tol = 1e-4 if variant == "angular" else 1e-3
    for k, name in enumerate(("r", "J_pose", "J_lmk", "m", "w")):
        assert _rel(T[k].numpy(), J[k]) < tol, name


@pytest.mark.parametrize("rig_name,iters", [("pinhole", 8), ("fisheye", 10)])
def test_angular_ba_solve_matches(rig_name, iters):
    """The angular solves of tests/test_ba.py (test_ba_angular_mode,
    test_ba_fisheye_rig) on the tiny problem, JAX and port side by side."""
    jp, tp = _problem(rig_name)
    js, jst = jba.ba_solve(jp, jba.BAOptions(iters=iters, angular=True))
    ts, tst = tba.ba_solve(tp, tba.BAOptions(iters=iters, angular=True))
    assert float(tst["cost"]) < float(tst["cost0"]) * 1e-2
    assert float(jst["cost"]) < float(jst["cost0"]) * 1e-2
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), atol=1e-4)
    np.testing.assert_allclose(ts.R.numpy(), np.asarray(js.R), atol=1e-4)
    np.testing.assert_allclose(ts.lmk.numpy(), np.asarray(js.lmk), atol=1e-4)
    gt = graft._tiny_problem(K=4, C=2, L=64, P=8, seed=0).state
    assert np.abs(ts.t.numpy() - np.asarray(gt.t)).max() < 5e-3


def test_numeric_ba_solve_matches():
    jp, tp = _problem("pinhole")
    js, _ = jba.ba_solve(jp, jba.BAOptions(iters=4, numeric=True))
    ts, tst = tba.ba_solve(tp, tba.BAOptions(iters=4, numeric=True))
    assert float(tst["cost"]) < float(tst["cost0"])
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), atol=1e-4)
    np.testing.assert_allclose(ts.lmk.numpy(), np.asarray(js.lmk), atol=1e-4)
    # the numeric solve lands where the analytic one does
    ta, _ = tba.ba_solve(tp, tba.BAOptions(iters=4))
    np.testing.assert_allclose(ts.t.numpy(), ta.t.numpy(), atol=1e-4)


def test_options_default_to_the_pixel_residual():
    names = {f.name for f in dataclasses.fields(tba.BAOptions)}
    assert {"angular", "numeric"} <= names
    o = tba.BAOptions()
    assert not o.angular and not o.numeric
