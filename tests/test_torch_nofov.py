"""The port's non-overlapping-FoV scale estimators against the JAX package's.

Motions of tests/test_nofov.py (camera 1 looks back from a 0.5 m lever),
the same seeded rays on both sides.  Tolerances: ``cam1_motion_terms``
1e-5; scale 1e-4 relative; inlier masks identical on every feature whose
epipolar angle is more than 1e-3 deg from the 0.5 deg threshold; the
degeneracy verdicts equal.  ``scale_grid``'s log grid is held value by
value first, to the exact grid and within 4e-6 of the JAX grid, since a
one-ulp change of a grid value can move its argmin; the chosen scales then
agree to 1e-4, which the 2.4% grid step allows only at the same index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import nofov as jn
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.frontend import nofov as tn

torch.set_num_threads(2)


def make_nofov_motion(seed, s_true=0.4, with_rotation=True, n=64, noise=0.0, w_scale=1.0):
    """tests/test_nofov.py's motion: body at the origin looking +z (camera
    0), camera 1 looking -z from a 0.5 m lever; rays of camera 1 at the
    keyframe and after the body motion (R_b, s_true d).  numpy float32."""
    rng = np.random.default_rng(seed)
    R_f_s1 = np.asarray(jgeo.so3_exp(jnp.asarray([0.0, np.pi, 0.0], jnp.float32)))
    t_f_s1 = np.array([0.5, 0.0, 0.0], np.float32)
    w = np.array([0.04, 0.09, 0.05]) * w_scale if with_rotation else np.zeros(3)
    R_b = np.asarray(jgeo.so3_exp(jnp.asarray(w, jnp.float32)))
    d = np.array([0.5, 0.2, 0.84])
    d = d / np.linalg.norm(d)
    pts_c1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                       rng.uniform(3, 7, n)], -1)
    pts_w = pts_c1 @ R_f_s1.T + t_f_s1

    def cam1_rays(R_body, t_body):
        R_ws = R_body @ R_f_s1
        t_ws = R_body @ t_f_s1 + t_body
        p_c = (pts_w - t_ws) @ R_ws
        return p_c / np.linalg.norm(p_c, axis=-1, keepdims=True)

    rays_kf = cam1_rays(np.eye(3), np.zeros(3))
    rays_cur = cam1_rays(R_b.astype(np.float64), s_true * d)
    if noise > 0:
        rays_cur = rays_cur + rng.standard_normal(rays_cur.shape) * noise
        rays_cur /= np.linalg.norm(rays_cur, axis=-1, keepdims=True)
    f = lambda x: np.asarray(x, np.float32)
    return f(R_b), f(d), f(R_f_s1), f(t_f_s1), f(rays_kf), f(rays_cur)


def _both(args):
    return [jnp.asarray(a) for a in args], [torch.as_tensor(a) for a in args]


def _angles(R_b, d, Rfs1, tfs1, rk, rc, s):
    """float64 epipolar angles (deg) of every feature at scale s."""
    R_1 = Rfs1.T.astype(np.float64) @ R_b @ Rfs1
    t1 = Rfs1.T @ ((R_b - np.eye(3)) @ tfs1) + s * (Rfs1.T @ d)
    n = np.cross(np.broadcast_to(t1, rc.shape), rc @ R_1.T)
    return np.degrees(np.arcsin(np.clip(np.abs((n * rk).sum(-1)) / np.linalg.norm(n, axis=-1),
                                        0, 1)))


def test_cam1_motion_terms_match():
    args = make_nofov_motion(0)[:4]
    ja, ta = _both(args)
    for a, b in zip(tn.cam1_motion_terms(*ta), jn.cam1_motion_terms(*ja)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("case", ["clean", "outliers", "noisy_invalid"])
def test_scale_ransac_matches(case):
    s_true = {"clean": 0.4, "outliers": 0.7, "noisy_invalid": 0.55}[case]
    args = list(make_nofov_motion(1, s_true=s_true, noise=0.0 if case == "clean" else 5e-5))
    n = args[4].shape[0]
    valid = np.ones(n, bool)
    if case == "outliers":
        args[5][:12] = np.roll(args[5][:12], 1, 0)
    if case == "noisy_invalid":
        valid[::5] = False
    ja, ta = _both(args)
    sj, inlj, okj = jn.scale_ransac(*ja, jnp.asarray(valid))
    st, inlt, okt = tn.scale_ransac(*ta, torch.as_tensor(valid))
    assert bool(okt) == bool(okj) is True
    assert float(st) == pytest.approx(float(sj), rel=1e-4)
    assert float(st) == pytest.approx(s_true, rel=0.05)
    away = np.abs(_angles(*args, float(sj)) - 0.5) > 1e-3
    np.testing.assert_array_equal(inlt.numpy()[away], np.asarray(inlj)[away])
    if case == "outliers":
        assert inlt.numpy()[:12].sum() <= 3


def test_scale_grid_values_match_the_jax_grid():
    """The log grid itself, value by value, on the bounds a baseline gives.
    The port's grid is the exact one rounded once (float64 chain); XLA's
    float32 log10, linspace and pow land a few units in the last place of
    the exponent away, which is up to 2e-6 relative at these bounds."""
    for lo, hi, n in ((0.05 * 0.31, 20.0 * 0.31, 256), (1e-6, 1e-5, 256), (0.3, 7.0, 64)):
        lo, hi = np.float32(lo), np.float32(hi)
        gj = np.asarray(jnp.geomspace(jnp.float32(lo), jnp.float32(hi), n))
        gt = tn._geomspace(torch.tensor(lo), torch.tensor(hi), n).numpy()
        exact = np.geomspace(np.float64(lo), np.float64(hi), n)
        np.testing.assert_array_equal(gt, exact.astype(np.float32))
        np.testing.assert_allclose(gt, gj, rtol=4e-6)
        assert gt[0] == lo and gt[-1] == hi and (np.diff(gt) > 0).all()


@pytest.mark.parametrize("case", ["clean", "noisy", "strong_rotation"])
def test_scale_grid_matches(case):
    kw = dict(clean={}, noisy=dict(noise=2e-4), strong_rotation=dict(w_scale=3.0))[case]
    args = make_nofov_motion(2, s_true=0.35, **kw)
    ja, ta = _both(args)
    n = args[4].shape[0]
    tnorm = 0.31  # a map-scale baseline length: bounds of the searched ratio
    lo, hi = np.float32(0.05) * np.float32(tnorm), np.float32(20.0) * np.float32(tnorm)
    sj, inlj, okj = jn.scale_grid(*ja, jnp.ones(n, bool), jnp.float32(lo), jnp.float32(hi))
    st, inlt, okt = tn.scale_grid(*ta, torch.ones(n, dtype=torch.bool), torch.tensor(lo),
                                  torch.tensor(hi))
    assert bool(okt) == bool(okj) is True
    assert float(st) == pytest.approx(float(sj), rel=1e-4)
    assert float(st) == pytest.approx(0.35, rel=0.1)
    away = np.abs(_angles(*args, float(sj)) - 0.5) > 1e-3
    np.testing.assert_array_equal(inlt.numpy()[away], np.asarray(inlj)[away])


def test_scale_grid_negative_half():
    """A motion whose scale is negative in the hypothesis (a backwards
    direction d) is found in the -s half of the grid on both sides."""
    R_b, d, Rfs1, tfs1, rk, rc = make_nofov_motion(3, s_true=0.4)
    args = (R_b, -d, Rfs1, tfs1, rk, rc)
    ja, ta = _both(args)
    n = rk.shape[0]
    sj, _, okj = jn.scale_grid(*ja, jnp.ones(n, bool), jnp.float32(0.05), jnp.float32(5.0))
    st, _, okt = tn.scale_grid(*ta, torch.ones(n, dtype=torch.bool), torch.tensor(0.05),
                               torch.tensor(5.0))
    assert bool(okt) and bool(okj)
    assert float(st) < 0 and float(st) == pytest.approx(float(sj), rel=1e-4)


@pytest.mark.parametrize("rotation,lever", [(False, 1e-3), (True, 1e-3), (True, 0.2),
                                            (True, 0.015)])
def test_is_degenerate_motion_matches(rotation, lever):
    R_b, d, Rfs1, tfs1, _, _ = make_nofov_motion(4, with_rotation=rotation)
    ja, ta = _both((R_b, d, Rfs1, tfs1))
    dj = bool(jn.is_degenerate_motion(*ja, min_lever=lever))
    dt = bool(tn.is_degenerate_motion(*ta, min_lever=lever))
    assert dt == dj
    if not rotation:
        assert dt
    # parallel a and b: a translation along the lever displacement
    _, a, _ = tn.cam1_motion_terms(*ta)
    d_par = (torch.as_tensor(Rfs1) @ a) / torch.linalg.norm(a)
    if rotation:
        assert bool(tn.is_degenerate_motion(ta[0], d_par, ta[2], ta[3], min_lever=1e-3))
        assert bool(jn.is_degenerate_motion(ja[0], jnp.asarray(d_par.numpy()), ja[2], ja[3],
                                            min_lever=1e-3))
