"""SO(3)/SE(3) math of the port against the JAX package.

Random inputs from a seeded numpy generator, including rotations near 0
and near pi, go through both packages.  Tolerance: 1e-5 absolute on unit
quantities (float32 with different op order); the near-pi log gets 1e-4
because its axis comes from a square root of 1 + cos(theta) ~ 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(2)

TOL = 1e-5


def _axis_angles(rng, n=32):
    """Generic, near-zero and near-pi rotation vectors (float32)."""
    axis = rng.standard_normal((3 * n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.05, 3.0, n), rng.uniform(0.0, 1e-4, n),
                          np.pi - rng.uniform(1e-4, 1e-2, n)])
    return (axis * ang[:, None]).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _both(fn_name, *args):
    j = np.asarray(getattr(jgeo, fn_name)(*[jnp.asarray(a) for a in args]))
    t = getattr(tgeo, fn_name)(*[_t(a) for a in args]).numpy()
    return j, t


@pytest.mark.parametrize("fn", ["so3_exp", "so3_left_jacobian", "so3_right_jacobian",
                                "so3_left_jacobian_inv", "skew"])
def test_vector_functions_match(rng, fn):
    w = _axis_angles(rng)
    if fn == "so3_left_jacobian_inv":
        w = w[np.linalg.norm(w, axis=1) < 3.0]  # cot(theta/2) blows up toward 2 pi
    j, t = _both(fn, w)
    np.testing.assert_allclose(t, j, atol=TOL, rtol=TOL)


def test_so3_log_matches_near_zero_and_pi(rng):
    w = _axis_angles(rng)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    j, t = _both("so3_log", R)
    n = len(w) // 3
    np.testing.assert_allclose(t[: 2 * n], j[: 2 * n], atol=TOL)
    # near pi the sign of the axis is arbitrary: compare rotations
    Rj = np.asarray(jgeo.so3_exp(jnp.asarray(j[2 * n:])))
    Rt = tgeo.so3_exp(_t(t[2 * n:])).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)


def test_single_rotation_and_batched_agree(rng):
    w = _axis_angles(rng, 4)
    Rb = tgeo.so3_exp(_t(w))
    for i in range(len(w)):
        np.testing.assert_array_equal(tgeo.so3_exp(_t(w[i])).numpy(), Rb[i].numpy())


@pytest.mark.parametrize("fn", ["pose_compose", "pose_local"])
def test_pose_pair_functions_match(rng, fn):
    wa, wb = _axis_angles(rng, 8), _axis_angles(rng, 8)
    Ra = np.asarray(jgeo.so3_exp(jnp.asarray(wa)))
    Rb = np.asarray(jgeo.so3_exp(jnp.asarray(wb)))
    ta = rng.standard_normal((len(wa), 3)).astype(np.float32)
    tb = rng.standard_normal((len(wa), 3)).astype(np.float32)
    if fn == "pose_local":
        Rb = Ra @ np.asarray(jgeo.so3_exp(jnp.asarray(0.3 * wb)))  # away from pi
    j = getattr(jgeo, fn)(*map(jnp.asarray, (Ra, ta, Rb, tb)))
    t = getattr(tgeo, fn)(*map(_t, (Ra, ta, Rb, tb)))
    j, t = (j, t) if fn == "pose_local" else (j[1], t[1])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


@pytest.mark.parametrize("fn", ["pose_retract", "se3_exp", "se3_log", "inv3x3",
                                "so3_orthonormalize"])
def test_other_functions_match(rng, fn):
    n = 16
    R = np.asarray(jgeo.so3_exp(jnp.asarray(_axis_angles(rng, n))))
    t = rng.standard_normal((len(R), 3)).astype(np.float32)
    dx = (0.2 * rng.standard_normal((len(R), 6))).astype(np.float32)
    if fn == "pose_retract":
        args = (R, t, dx)
    elif fn == "se3_log":
        args = (R, t)
    elif fn == "se3_exp":
        args = (dx,)
    elif fn == "inv3x3":
        A = rng.standard_normal((n, 3, 3)).astype(np.float32)
        args = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32),)
    else:
        args = ((R * (1 + 1e-4 * rng.standard_normal(R.shape))).astype(np.float32),)
    j = getattr(jgeo, fn)(*map(jnp.asarray, args))
    t_ = getattr(tgeo, fn)(*map(_t, args))
    j = j if isinstance(j, tuple) else (j,)
    t_ = t_ if isinstance(t_, tuple) else (t_,)
    for a, b in zip(j, t_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("where", ["zero", "generic", "near_pi"])
def test_jacfwd_through_safe_branches(rng, where):
    """torch.func.jacfwd through exp/log matches jax.jacfwd, finite at the
    switch points (tangents must not leak NaN through the where branches)."""
    base = {"zero": np.zeros(3), "generic": np.array([0.3, -0.2, 0.5]),
            "near_pi": np.array([0.0, 0.0, np.pi - 2e-3])}[where].astype(np.float32)
    R0 = np.asarray(jgeo.so3_exp(jnp.asarray(base)))

    def jfun(d):
        return jgeo.so3_log(jnp.asarray(R0) @ jgeo.so3_exp(d))

    def tfun(d):
        return tgeo.so3_log(_t(R0) @ tgeo.so3_exp(d))

    d0 = np.zeros(3, np.float32)
    Jj = np.asarray(jax.jacfwd(jfun)(jnp.asarray(d0)))
    Jt = torch.func.jacfwd(tfun)(_t(d0)).numpy()
    assert Jt.dtype == np.float32 and np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt, Jj, atol=1e-4)
