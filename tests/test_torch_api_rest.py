"""The last public functions of the JAX package's geometry, factors,
triangulation and BA modules, against their ports.

Seeded numpy inputs go through both packages.  Tolerances: 1e-5 absolute on
unit quantities (float32 with another op order), as tests/test_torch_geometry.py
states; residuals of whitened factors 1e-4 relative to their size (the
whitening multiplies the chart's float32 error by up to 10); the depth
init 1e-5 m on points a few metres out.  ``make_problem`` is held by the
solve it feeds: ``ba_solve(make_problem(...))`` within tests/test_torch_backend.py's
1e-4 on poses and 1e-3 on landmarks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.backend import ba as jba
from sadvio_tpu.backend import factors as jfac
from sadvio_tpu.frontend import triangulate as jtri
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.backend import ba as tba
from sadvio_tpu_torch.backend import factors as tfac
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.frontend import triangulate as ttri
from sadvio_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(2)

TOL = 1e-5
RES_RTOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _rotations(rng, n):
    """Rotations from axis-angles up to near pi, float32."""
    w = rng.standard_normal((n, 3))
    w *= (rng.uniform(0.0, 3.1, n) / np.linalg.norm(w, axis=1))[:, None]
    return np.asarray(jgeo.so3_exp(jnp.asarray(w, jnp.float32)))


def _poses(rng, n):
    return _rotations(rng, n), rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)


def test_so3_right_jacobian_inv(rng):
    w = rng.standard_normal((64, 3))
    w = (w * (rng.uniform(0.0, 2.5, 64) / np.linalg.norm(w, axis=1))[:, None]).astype(np.float32)
    w[:4] *= 1e-5  # the small-angle branch
    j = np.asarray(jgeo.so3_right_jacobian_inv(jnp.asarray(w)))
    t = tgeo.so3_right_jacobian_inv(_t(w)).numpy()
    np.testing.assert_allclose(t, j, atol=TOL)
    # the inverse of the right Jacobian
    np.testing.assert_allclose(t @ tgeo.so3_right_jacobian(_t(w)).numpy(),
                               np.broadcast_to(np.eye(3), t.shape), atol=1e-5)


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_pose_identity(shape):
    Rj, tj = jgeo.pose_identity(shape)
    Rt, tt = tgeo.pose_identity(shape)
    assert Rt.dtype == torch.float32 and tuple(Rt.shape) == tuple(Rj.shape)
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_pose_apply(rng):
    R, t = _poses(rng, 32)
    p = rng.normal(0.0, 5.0, (32, 3)).astype(np.float32)
    j = np.asarray(jgeo.pose_apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(p)))
    np.testing.assert_allclose(tgeo.pose_apply(_t(R), _t(t), _t(p)).numpy(), j, atol=TOL * 10)


def test_pose_matrix_round_trip(rng):
    R, t = _poses(rng, 16)
    Mj = np.asarray(jgeo.pose_to_matrix(jnp.asarray(R), jnp.asarray(t)))
    Mt = tgeo.pose_to_matrix(_t(R), _t(t))
    np.testing.assert_array_equal(Mt.numpy(), Mj)
    Rj, tj = jgeo.matrix_to_pose(jnp.asarray(Mj))
    Rt, tt = tgeo.matrix_to_pose(Mt)
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    single = tgeo.pose_to_matrix(_t(R[0]), _t(t[0]))
    np.testing.assert_array_equal(single.numpy(), Mj[0])


def test_quaternions(rng):
    q = rng.standard_normal((64, 4)).astype(np.float32)
    for i in range(4):  # each component leads somewhere: every Shepperd branch
        q[i, i] = 10.0
    q[4:8] *= -1.0
    Rj = np.asarray(jgeo.quat_to_rot(jnp.asarray(q)))
    Rt = tgeo.quat_to_rot(_t(q)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=TOL)
    qj = np.asarray(jgeo.rot_to_quat(jnp.asarray(Rj)))
    qt = tgeo.rot_to_quat(_t(Rj)).numpy()
    np.testing.assert_allclose(qt, qj, atol=TOL)
    # a round trip gives the same rotation (q and -q alike)
    np.testing.assert_allclose(tgeo.quat_to_rot(_t(qt)).numpy(), Rj, atol=TOL * 10)
    eye = tgeo.rot_to_quat(torch.eye(3))
    np.testing.assert_array_equal(eye.numpy(), np.asarray(jgeo.rot_to_quat(jnp.eye(3))))


def _sqrt_info(rng, n):
    A = rng.normal(0.0, 1.0, (n, n))
    return (np.linalg.cholesky(A @ A.T + n * np.eye(n)).T * 3.0).astype(np.float32)


def _close_residual(t, j):
    np.testing.assert_allclose(t, j, atol=RES_RTOL * max(1.0, float(np.abs(j).max())))


def test_pose_prior_residual(rng):
    W = _sqrt_info(rng, 6)
    for _ in range(8):
        (R, R0), (t, t0) = _poses(rng, 2)
        j = np.asarray(jfac.pose_prior_residual(*map(jnp.asarray, (R, t, R0, t0, W))))
        _close_residual(tfac.pose_prior_residual(*map(_t, (R, t, R0, t0, W))).numpy(), j)
    Rb, tb = _poses(rng, 5)
    jv = jax.vmap(jfac.pose_prior_residual, (0, 0, None, None, None))(
        *map(jnp.asarray, (Rb, tb, R0, t0, W)))
    _close_residual(tfac.pose_prior_residual(*map(_t, (Rb, tb, R0, t0, W))).numpy(),
                    np.asarray(jv))


def test_scale_prior_residual(rng):
    ls, ls0 = rng.normal(0.0, 0.3, (2, 16)).astype(np.float32)
    j = np.asarray(jfac.scale_prior_residual(jnp.asarray(ls), jnp.asarray(ls0), 50.0))
    np.testing.assert_array_equal(tfac.scale_prior_residual(_t(ls), _t(ls0), 50.0).numpy(), j)


def test_motion2d_residual(rng):
    n = 24
    Ri, ti = _poses(rng, n)
    Rj, tj = _poses(rng, n)
    m2 = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
    dt = rng.uniform(0.02, 0.5, n).astype(np.float32)
    W = np.stack([_sqrt_info(rng, 6) for _ in range(n)])
    args = (Ri, ti, Rj, tj, m2, dt, W)
    j = np.asarray(jfac.motion2d_residual(*map(jnp.asarray, args)))
    _close_residual(tfac.motion2d_residual(*map(_t, args)).numpy(), j)
    # the pose it predicts is the measured one: zero residual
    Rd = np.asarray(jgeo.so3_exp(jnp.asarray(np.stack([0 * dt, 0 * dt, m2[:, 1] * dt], -1))))
    Rp = Ri @ Rd
    tp = ti + Ri[:, :, 0] * (m2[:, 0] * dt)[:, None]
    r0 = tfac.motion2d_residual(*map(_t, (Ri, ti, Rp, tp, m2, dt, W))).numpy()
    assert np.abs(r0).max() < 1e-3


def test_depth_init(rng):
    n, m = 40, 4
    p_true = rng.normal(0.0, 1.0, (n, 3)) + [0.0, 0.0, 6.0]
    origins = rng.normal(0.0, 0.3, (n, m, 3))
    d = p_true[:, None] - origins
    depth = np.linalg.norm(d, axis=-1)
    dirs = d / depth[..., None]
    depth = depth + rng.normal(0.0, 0.01, depth.shape)
    mask = rng.uniform(size=(n, m)) > 0.2
    depth[0, :] = -1.0  # no usable depth: not ok
    depth[1, 0] = 80.0  # beyond max_depth: ignored
    mask[2, :] = False
    args = [a.astype(np.float32) for a in (origins, dirs, depth)] + [mask]
    pj, okj = jtri.depth_init(*map(jnp.asarray, args))
    pt, okt = ttri.depth_init(*map(_t, args))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not okt[0] and not okt[2] and okt[3:].all()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    np.testing.assert_allclose(pt.numpy()[okt.numpy()], p_true[okt.numpy()], atol=0.05)


@pytest.fixture(scope="module")
def window():
    """A synthetic stereo window (K=4, L=64) with noisy poses and landmarks,
    from tests/test_ba.py's recipe."""
    from sadvio_tpu.data.window import Observations, WindowState
    from sadvio_tpu.pipeline.synthetic import make_rig

    rng = np.random.default_rng(4)
    K, L, C = 4, 64, 2
    rig = make_rig(320, 240)
    lmk = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                    rng.uniform(4, 8, L)], -1).astype(np.float32)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 0.03, (K, 3)), jnp.float32)))
    t = np.stack([np.linspace(0, 0.4, K), 0.05 * rng.standard_normal(K),
                  np.zeros(K)], -1).astype(np.float32)
    uv = np.zeros((K, C, L, 2), np.float32)
    mask = np.zeros((K, C, L), bool)
    for k in range(K):
        for c in range(C):
            p_f = (lmk - t[k]) @ R[k]
            p_c = p_f - np.asarray(rig.t_f_s[c])
            uv[k, c] = 200.0 * p_c[:, :2] / p_c[:, 2:] + [160.0, 120.0]
            mask[k, c] = (np.abs(uv[k, c] - [160, 120]) < [150, 110]).all(-1)
    uv += rng.normal(0.0, 0.3, uv.shape).astype(np.float32)
    dt = rng.normal(0, 0.01, t.shape).astype(np.float32) * (np.arange(K) > 0)[:, None]
    dl = rng.normal(0, 0.05, lmk.shape).astype(np.float32)
    st = WindowState.create(K, L).replace(
        R=jnp.asarray(R), t=jnp.asarray(t + dt), kf_mask=jnp.ones(K, bool),
        lmk=jnp.asarray(lmk + dl), lmk_mask=jnp.ones(L, bool))
    return st, Observations(uv=jnp.asarray(uv), mask=jnp.asarray(mask)), rig, t


@pytest.mark.parametrize("fixed", [None, (True, True, False, False)])
def test_make_problem_feeds_the_solve(window, fixed):
    st, obs, rig, t_true = window
    fm = None if fixed is None else np.asarray(fixed)
    pj = jba.make_problem(st, obs, rig, fixed_mask=None if fm is None else jnp.asarray(fm))
    to_np = lambda x: jax.tree.map(np.asarray, x)
    pt = tba.make_problem(from_numpy(to_np(st)), from_numpy(to_np(obs)), from_numpy(to_np(rig)),
                          fixed_mask=None if fm is None else torch.as_tensor(fm))
    # the defaults: no IMU factor, an empty 8-slot prior, slot 0 fixed
    assert not bool(pt.imu.mask.any()) and pt.priors.P == pj.priors.P == 8
    assert pt.opt_lmk_only is False and not bool(pj.opt_lmk_only)
    np.testing.assert_array_equal(pt.fixed_mask.numpy(), np.asarray(pj.fixed_mask))
    opts = jba.BAOptions(iters=6)
    sj, _ = jba.ba_solve(pj, opts)
    stt, stats = tba.ba_solve(pt, tba.BAOptions(iters=6))
    np.testing.assert_allclose(stt.R.numpy(), np.asarray(sj.R), atol=1e-4)
    np.testing.assert_allclose(stt.t.numpy(), np.asarray(sj.t), atol=1e-4)
    np.testing.assert_allclose(stt.lmk.numpy(), np.asarray(sj.lmk), atol=1e-3)
    assert float(stats["cost"]) < 0.1 * float(stats["cost0"])  # it solved something
    if fixed is None:
        assert np.abs(stt.t.numpy() - t_true).max() < 0.01
