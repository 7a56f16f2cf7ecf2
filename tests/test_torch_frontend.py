"""PnP, ESKF, triangulation and the epipolar gate of the port against the
JAX package.

RANSAC: the port draws hypotheses from a torch.Generator, the JAX package
from jax.random, so for parity the test hands the port the JAX package's
own draws (sample_idx) and then requires the same pose to 1e-4 (float32
Gauss-Newton on the same data); with its own generator the port is judged
on outcomes only.  ESKF 1e-4; triangulation 1e-4 relative; epipolar gate
identical masks away from the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import epipolar as jepi, eskf as jeskf, pnp as jpnp
from sadvio_tpu.frontend import triangulate as jtri
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.frontend import epipolar as tepi, eskf as teskf, pnp as tpnp
from sadvio_tpu_torch.frontend import triangulate as ttri
from sadvio_tpu_torch.models import cameras as tcam

torch.set_num_threads(2)

N = 200
N_HYP = 48


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    p_w = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(4, 9, N)], -1)
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.05, -0.03, 0.02], jnp.float32)))
    t = np.array([0.2, -0.1, 0.05], np.float32)
    Rfs, tfs = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    cam = jcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    uv, vis = cam.project(np.asarray(jcam.world_to_cam(*map(jnp.asarray, (R, t, Rfs, tfs)),
                                                       jnp.asarray(p_w, jnp.float32))))
    uv = np.asarray(uv) + rng.standard_normal((N, 2)) * 0.3
    out = rng.uniform(size=N) < 0.2
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    valid = np.asarray(vis) & (rng.uniform(size=N) < 0.9)
    R_pred = np.asarray(jgeo.so3_exp(jnp.asarray([0.06, -0.02, 0.03], jnp.float32)))
    t_pred = (t + np.array([0.03, 0.02, -0.02])).astype(np.float32)
    return dict(p_w=p_w.astype(np.float32), uv=uv.astype(np.float32), valid=valid, R=R, t=t,
                Rfs=Rfs, tfs=tfs, R_pred=R_pred, t_pred=t_pred, outlier=out)


def _args(s, conv):
    return [conv(s[k]) for k in ("Rfs", "tfs", "p_w", "uv", "valid", "R_pred", "t_pred")]


def test_pnp_matches_with_the_same_hypotheses(scene):
    key = jax.random.PRNGKey(3)
    # the draws pnp.py makes for its hypotheses
    idx = jax.vmap(lambda k: jax.random.randint(k, (4,), 0, N))(jax.random.split(key, N_HYP))
    jc = jcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    tc = tcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    Rj, tj, inl_j, ok_j, cov_j = jpnp.pnp_ransac(jc, *_args(scene, jnp.asarray), key, n_hyp=N_HYP)
    Rt, tt, inl_t, ok_t, cov_t = tpnp.pnp_ransac(tc, *_args(scene, _t), sample_idx=_t(idx))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert bool(ok_t) and bool(ok_j)
    cj = np.asarray(cov_j, np.float64)
    assert np.linalg.norm(cov_t.numpy() - cj) / np.linalg.norm(cj) < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_with_own_generator_recovers_pose(scene, seed):
    tc = tcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    gen = torch.Generator().manual_seed(seed)
    R, t, inl, ok, _ = tpnp.pnp_ransac(tc, *_args(scene, _t), gen)
    assert bool(ok)
    assert np.linalg.norm(t.numpy() - scene["t"]) < 0.01
    inl = inl.numpy()
    good = scene["valid"] & ~scene["outlier"]
    assert (inl & good).sum() > 0.9 * good.sum()
    assert (inl & scene["outlier"] & scene["valid"]).sum() <= 0.05 * good.sum()


def test_eskf_update_matches(scene):
    jc = jcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    tc = tcam.make_pinhole(458.0, 457.0, 367.0, 248.0)
    pre_cov = np.diag(np.r_[np.full(3, 1e-4), np.full(3, 1e-3), np.full(3, 4e-3)])
    pre_cov = (pre_cov + 1e-6).astype(np.float32)
    Pj = jeskf.imu_prior_covariance(jnp.asarray(pre_cov))
    Pt = teskf.imu_prior_covariance(_t(pre_cov))
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-6)
    s = scene
    valid = s["valid"] & ~s["outlier"]
    jo = jeskf.eskf_update(jc, *map(jnp.asarray, (s["Rfs"], s["tfs"], s["R_pred"], s["t_pred"])),
                           Pj, *map(jnp.asarray, (s["p_w"], s["uv"], valid)))
    to = teskf.eskf_update(tc, *map(_t, (s["Rfs"], s["tfs"], s["R_pred"], s["t_pred"])),
                           Pt, *map(_t, (s["p_w"], s["uv"], valid)))
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=1e-4)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=1e-4)
    Pj_post = np.asarray(jo[2], np.float64)
    assert np.linalg.norm(to[2].numpy() - Pj_post) / np.linalg.norm(Pj_post) < 1e-3
    assert int(to[3]) == int(jo[3])


def test_stereo_triangulate_matches(rng):
    n = 64
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(1, 45, n)], -1)
    origins = np.array([[0.0, 0.0, 0.0], [0.11, 0.0, 0.0]])
    rays = p[None] - origins[:, None]
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    rays += rng.standard_normal(rays.shape) * 1e-4
    valid = rng.uniform(size=(2, n)) < 0.9
    args = (origins.astype(np.float32), rays.astype(np.float32), valid)
    pj, okj = jtri.stereo_triangulate(*map(jnp.asarray, args))
    pt, okt = ttri.stereo_triangulate(*map(_t, args))
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() > n // 3
    np.testing.assert_allclose(pt.numpy()[okj], np.asarray(pj)[okj], rtol=1e-4, atol=1e-4)


def test_epipolar_filter_matches(rng):
    n = 200
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.01, 0.02, -0.01], jnp.float32)))
    t_ab = np.array([0.1, 0.0, 0.01], np.float32)
    ra = rng.standard_normal((n, 3)) + [0, 0, 4]
    ra /= np.linalg.norm(ra, axis=1, keepdims=True)
    rb = rng.standard_normal((n, 3)) + [0, 0, 4]
    rb /= np.linalg.norm(rb, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    args = (R, t_ab, ra.astype(np.float32), rb.astype(np.float32))
    ej = np.asarray(jepi.epipolar_angular_error(*map(jnp.asarray, args)))
    et = tepi.epipolar_angular_error(*map(_t, args)).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-6)
    mj = np.asarray(jepi.epipolar_filter(*map(jnp.asarray, args), jnp.asarray(valid), 5.0))
    mt = tepi.epipolar_filter(*map(_t, args), _t(valid), 5.0).numpy()
    away = np.abs(np.rad2deg(ej) - 5.0) > 1e-3
    np.testing.assert_array_equal(mt[away], mj[away])
    assert 0 < mj.sum() < n
