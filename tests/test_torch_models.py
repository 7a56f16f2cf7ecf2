"""Camera and IMU models of the port against the JAX package.

Same numpy inputs through both.  Tolerances: pixel outputs 1e-3 px
(float32 division at ~400 px magnitudes), Jacobians 1e-4 relative; IMU
deltas 1e-5 absolute; the 9x9 covariance and the whitening are compared
relative to their own scale (entries span ~10 decades), 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.models import cameras as jcam, imu as jimu
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.models import cameras as tcam, imu as timu

torch.set_num_threads(2)

FIELDS = ["dR", "dv", "dp", "dt", "J_dR_bg", "J_dv_ba", "J_dv_bg", "J_dp_ba", "J_dp_bg"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _cams():
    j = jcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    return j, tcam.make_pinhole(458.0, 457.0, 367.0, 248.0)


def _points(rng, n=64):
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-1, 9, n)], -1)
    return p.astype(np.float32)


@pytest.mark.parametrize("fn", ["project", "project_jac"])
def test_pinhole_projection_matches(rng, fn):
    jc, tc = _cams()
    p = _points(rng)
    j = getattr(jc, fn)(jnp.asarray(p))
    t = getattr(tc, fn)(_t(p))
    np.testing.assert_array_equal(t[-1].numpy(), np.asarray(j[-1]))  # valid masks
    v = np.asarray(j[-1])
    np.testing.assert_allclose(t[0].numpy()[v], np.asarray(j[0])[v], atol=1e-3)
    if fn == "project_jac":
        np.testing.assert_allclose(t[1].numpy()[v], np.asarray(j[1])[v], rtol=1e-4, atol=1e-4)


def test_backproject_and_world_chain_match(rng):
    jc, tc = _cams()
    uv = np.stack([rng.uniform(0, 752, 32), rng.uniform(0, 480, 32)], -1).astype(np.float32)
    np.testing.assert_allclose(tc.backproject(_t(uv)).numpy(),
                               np.asarray(jc.backproject(jnp.asarray(uv))), atol=1e-6)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(0.2 * rng.standard_normal((4, 3)), jnp.float32)))
    t = rng.standard_normal((4, 3)).astype(np.float32)
    Rfs, tfs = np.eye(3, dtype=np.float32), np.array([0.11, 0.0, 0.0], np.float32)
    p = _points(rng, 16) + np.array([0, 0, 3], np.float32)
    args = (R[:, None], t[:, None], Rfs, tfs, p[None])
    jo = jcam.project_world_jac(jc, *map(jnp.asarray, args))
    to = tcam.project_world_jac(tc, *map(_t, args))
    v = np.asarray(jo[3])
    np.testing.assert_array_equal(to[3].numpy(), v)
    np.testing.assert_allclose(to[0].numpy()[v], np.asarray(jo[0])[v], atol=1e-3)
    for a, b in zip(jo[1:3], to[1:3]):
        np.testing.assert_allclose(b.numpy()[v], np.asarray(a)[v], rtol=1e-4, atol=1e-3)
    jb = jcam.bearing_world(jc, *map(jnp.asarray, (R[0], t[0], Rfs, tfs, uv)))
    tb = tcam.bearing_world(tc, *map(_t, (R[0], t[0], Rfs, tfs, uv)))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


def _stream(rng, n=48, pad=8):
    acc = np.concatenate([rng.standard_normal((n, 3)) * 0.5 + [0.2, -0.1, 9.81],
                          np.full((pad, 3), 123.0)]).astype(np.float32)
    gyr = np.concatenate([rng.standard_normal((n, 3)) * 0.3,
                          np.full((pad, 3), -9.0)]).astype(np.float32)
    dt = np.concatenate([np.full(n, 0.005), np.zeros(pad)]).astype(np.float32)
    ba = (0.05 * rng.standard_normal(3)).astype(np.float32)
    bg = (0.01 * rng.standard_normal(3)).astype(np.float32)
    return acc, gyr, dt, ba, bg


def _preints(rng):
    acc, gyr, dt, ba, bg = _stream(rng)
    jp = jimu.preintegrate(*map(jnp.asarray, (acc, gyr, dt, ba, bg)), jimu.ImuParams.euroc())
    tp = timu.preintegrate(*map(_t, (acc, gyr, dt, ba, bg)), timu.ImuParams.euroc())
    return jp, tp


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)


def test_preintegrate_matches_with_padding(rng):
    jp, tp = _preints(rng)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   atol=1e-5, err_msg=f)
    assert _rel(tp.cov.numpy(), np.asarray(jp.cov, np.float64)) < 1e-4


def test_sqrt_info_matches(rng):
    jp, tp = _preints(rng)
    Wj = np.asarray(jimu.sqrt_info(jp), np.float64)
    Wt = timu.sqrt_info(tp).numpy()
    assert _rel(Wt, Wj) < 1e-4
    # and it whitens: W cov W^T = I (to the equilibration jitter)
    np.testing.assert_allclose(Wt @ tp.cov.numpy() @ Wt.T, np.eye(9), atol=2e-2)


@pytest.mark.parametrize("fn", ["predict", "residual", "bias_corrected_deltas"])
def test_prediction_and_residual_match(rng, fn):
    jp, tp = _preints(rng)
    tp_conv = from_numpy(jax.tree.map(np.asarray, jp))  # from_numpy carries it over
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp_conv, f).numpy(), np.asarray(getattr(jp, f)))
    R_i = np.asarray(jgeo.so3_exp(jnp.array([0.3, 0.2, 0.1], jnp.float32)))
    x = [R_i] + [rng.standard_normal(3).astype(np.float32) for _ in range(4)]
    R_j = (R_i @ np.asarray(jp.dR)).astype(np.float32)
    y = [R_j, rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32)]
    if fn == "predict":
        jo = jimu.predict(jp, *map(jnp.asarray, x[:3]), ba=jnp.asarray(x[3]), bg=jnp.asarray(x[4]))
        to = timu.predict(tp, *map(_t, x[:3]), ba=_t(x[3]), bg=_t(x[4]))
    elif fn == "residual":
        args = (*x, *y)
        jo = (jimu.residual(jp, *map(jnp.asarray, args)),)
        to = (timu.residual(tp, *map(_t, args)),)
    else:
        jo = jimu.bias_corrected_deltas(jp, jnp.asarray(x[3]), jnp.asarray(x[4]))
        to = timu.bias_corrected_deltas(tp, _t(x[3]), _t(x[4]))
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=1e-5)


def test_residual_jacobian_matches(rng):
    """torch.func.jacfwd of the IMU residual over a pose delta == jax.jacfwd."""
    from sadvio_tpu_torch.utils import geometry as tgeo

    jp, tp = _preints(rng)
    R_i = np.eye(3, dtype=np.float32)
    R_j = np.asarray(jp.dR)
    p_i, v_i, p_j, v_j = (rng.standard_normal(3).astype(np.float32) for _ in range(4))
    z3 = np.zeros(3, np.float32)

    def jf(d):
        R, p = jgeo.pose_retract(jnp.asarray(R_j), jnp.asarray(p_j), d)
        return jimu.residual(jp, jnp.asarray(R_i), jnp.asarray(p_i), jnp.asarray(v_i),
                             jnp.asarray(z3), jnp.asarray(z3), R, p, jnp.asarray(v_j))

    def tf(d):
        R, p = tgeo.pose_retract(_t(R_j), _t(p_j), d)
        return timu.residual(tp, _t(R_i), _t(p_i), _t(v_i), _t(z3), _t(z3), R, p, _t(v_j))

    d0 = np.zeros(6, np.float32)
    np.testing.assert_allclose(torch.func.jacfwd(tf)(_t(d0)).numpy(),
                               np.asarray(jax.jacfwd(jf)(jnp.asarray(d0))), atol=1e-4)
