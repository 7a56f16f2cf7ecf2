"""Essential-matrix and homography RANSAC of the port against the JAX
package, on the same numpy inputs.

The JAX package draws its hypothesis subsets from ``jax.random``; the tests
reproduce those draws (``split`` then ``randint`` per hypothesis, as the
package does) and hand them to the port as ``sample_idx``, so both score the
same hypotheses.

Tolerances, with reasons: with the same draws, R and the unit translation
agree to 1e-4 and the inlier masks are identical away from the threshold
(Sampson and transfer errors are compared at 1e-5-scale thresholds; an
error within 5% of the threshold may land on either side in float32).  The
null vectors come from a float64 eigendecomposition of A^T A in the port and
a float32 SVD of A in the JAX package, hence 1e-4 and not equality.  With
the port's own generator the outcomes are held: ok, rotation and direction
within the JAX package's own test bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import epipolar as jepi
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.frontend import epipolar as tepi

torch.set_num_threads(2)

T = lambda x: torch.as_tensor(np.array(x))


def _draws(key, n_hyp, k, N):
    keys = jax.random.split(key, n_hyp)
    return np.stack([np.asarray(jax.random.randint(kk, (k,), 0, N)) for kk in keys])


def _two_view(rng, n=96, n_out=10):
    p = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    R_ab = np.asarray(jgeo.so3_exp(jnp.asarray([0.03, -0.05, 0.02])), np.float64)
    t_ab = np.asarray([0.3, 0.05, -0.1])
    pb = (p - t_ab) @ R_ab
    ra = (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    rb = (pb / np.linalg.norm(pb, axis=-1, keepdims=True)).astype(np.float32)
    rb[:n_out] = np.roll(rb[:n_out], 1, 0)  # outliers
    valid = np.ones(n, bool)
    valid[-3:] = False
    return ra, rb, valid, R_ab, t_ab / np.linalg.norm(t_ab)


def _planar(rng, n=120):
    n_true = np.asarray([0.1, -0.05, 1.0])
    n_true /= np.linalg.norm(n_true)
    xy = rng.uniform(-2.5, 2.5, (n, 2))
    z = (5.0 - xy @ n_true[:2]) / n_true[2]
    X = np.concatenate([xy, z[:, None]], -1)
    R_ab = np.asarray(jgeo.so3_exp(jnp.asarray([0.04, -0.06, 0.02])), np.float64)
    t_ab = np.asarray([0.4, 0.1, -0.2])
    Xb = (X - t_ab) @ R_ab
    ra = (X / np.linalg.norm(X, axis=-1, keepdims=True)).astype(np.float32)
    rb = (Xb / np.linalg.norm(Xb, axis=-1, keepdims=True)).astype(np.float32)
    return ra, rb, np.ones(n, bool), R_ab, t_ab / np.linalg.norm(t_ab), n_true


def _same_mask_off_threshold(mt, mj, err, thresh):
    clear = np.abs(err - thresh) > 0.05 * thresh
    np.testing.assert_array_equal(mt[clear], mj[clear])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_essential_ransac_same_draws(rng, seed):
    ra, rb, valid, _, _ = _two_view(rng)
    key = jax.random.PRNGKey(seed)
    Rj, tj, inlj, okj = jepi.essential_ransac(jnp.asarray(ra), jnp.asarray(rb),
                                              jnp.asarray(valid), key)
    Rt, tt, inlt, okt = tepi.essential_ransac(T(ra), T(rb), T(valid),
                                              sample_idx=T(_draws(key, 64, 8, len(ra))))
    assert bool(okt) == bool(okj) is True
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    Ej = jepi._eight_point(jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(inlj, jnp.float32))
    err = np.asarray(jepi._sampson(Ej, jnp.asarray(ra), jnp.asarray(rb)))
    _same_mask_off_threshold(inlt.numpy(), np.asarray(inlj), err, 1e-5)
    assert inlt.sum() >= 75 and not inlt[-3:].any()


def test_essential_ransac_own_generator(rng):
    ra, rb, valid, R_ab, t_dir = _two_view(rng)
    gen = torch.Generator().manual_seed(5)
    R, t, inl, ok = tepi.essential_ransac(T(ra), T(rb), T(valid), gen)
    assert bool(ok)
    tn = t.double().numpy()
    assert min(np.linalg.norm(tn - t_dir), np.linalg.norm(tn + t_dir)) < 0.05
    dR = np.asarray(jgeo.so3_log(jnp.asarray(R.numpy().T @ R_ab, jnp.float32)))
    assert np.abs(dR).max() < 0.02
    assert not inl[:10].all()


def test_eight_point_and_decomposition_match(rng):
    ra, rb, valid, _, _ = _two_view(rng, n_out=0)
    w = valid.astype(np.float32)
    Ej = np.asarray(jepi._eight_point(jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(w)))
    Et = tepi._eight_point(T(ra), T(rb), T(w)).numpy()
    s = np.sign((Ej * Et).sum())  # a null vector is defined up to sign
    np.testing.assert_allclose(s * Et, Ej, atol=1e-4)
    Rj, tj, vj = jepi.decompose_essential(jnp.asarray(Ej), jnp.asarray(ra), jnp.asarray(rb),
                                          jnp.asarray(valid))
    Rt, tt, vt = tepi.decompose_essential(T(Ej), T(ra), T(rb), T(valid))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert int(vt) == int(vj) == int(valid.sum())


@pytest.mark.parametrize("seed", [0, 3])
def test_homography_ransac_same_draws(rng, seed):
    ra, rb, valid, R_ab, t_dir, n_true = _planar(rng)
    key = jax.random.PRNGKey(seed)
    Rj, tj, nj, inlj, okj = jepi.homography_ransac(jnp.asarray(ra), jnp.asarray(rb),
                                                   jnp.asarray(valid), key)
    Rt, tt, nt, inlt, okt = tepi.homography_ransac(T(ra), T(rb), T(valid),
                                                   sample_idx=T(_draws(key, 64, 4, len(ra))))
    assert bool(okt) == bool(okj) is True
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-4)
    assert int(inlt.sum()) >= 0.95 * int(inlj.sum()) and int(inlt.sum()) >= 100
    np.testing.assert_allclose(Rt.numpy(), R_ab, atol=5e-3)
    np.testing.assert_allclose(tt.numpy(), t_dir, atol=2e-2)
    assert abs(abs(float(nt.double().numpy() @ n_true)) - 1.0) < 1e-2


def test_homography_dlt_and_transfer_error_match(rng):
    ra, rb, valid, *_ = _planar(rng)
    w = valid.astype(np.float32)
    Hj = jepi._homography_dlt(jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(w))
    Ht = tepi._homography_dlt(T(ra), T(rb), T(w))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-4)
    ej = np.asarray(jepi._transfer_error(Hj, jnp.asarray(ra), jnp.asarray(rb)))
    et = tepi._transfer_error(T(np.asarray(Hj)), T(ra), T(rb)).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-7)
    # batched over hypotheses: the same result row by row
    ws = np.stack([w, w * (np.arange(len(w)) % 2)])
    Hb = tepi._homography_dlt(T(ra), T(rb), T(ws))
    np.testing.assert_allclose(Hb[0].numpy(), Ht.numpy(), atol=1e-6)


def test_homography_pure_rotation_reports_zero_translation(rng):
    ra, _, valid, *_ = _planar(rng)
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.02, 0.05, -0.01])), np.float64)
    rb = (ra.astype(np.float64) @ R).astype(np.float32)
    key = jax.random.PRNGKey(0)
    Rj, tj, _, _, okj = jepi.homography_ransac(jnp.asarray(ra), jnp.asarray(rb),
                                               jnp.asarray(valid), key)
    Rt, tt, _, _, okt = tepi.homography_ransac(T(ra), T(rb), T(valid),
                                               sample_idx=T(_draws(key, 64, 4, len(ra))))
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-3)
    assert float(tt.abs().max()) == 0.0 == float(jnp.abs(tj).max())
