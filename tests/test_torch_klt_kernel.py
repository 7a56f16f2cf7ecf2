"""The LK iteration loop of the port (``lk_iterate_ref``, the plain version
the CUDA kernel is checked against) against the JAX package's Pallas
kernel run in interpret mode.

Fixture of tests/test_klt_kernel.py: a 96x320 blocky texture shifted by
(1.7, -1.2) px, N=24 features, radius 5, 12 iterations.  Both sides get
the same templates (the JAX package's _templates).  Tolerances: 1e-3 px
and 1e-3 intensity on features with a good template -- float32 with a
different summation order; the Pallas kernel clamps its patch corner to a
+-40 x +-6 px window and the port to the image edge, which agree for
every feature that stays inside that drift budget, as these do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import klt as jklt
from sadvio_tpu.frontend.detect import bilinear_sample
from sadvio_tpu.ops import klt_kernel as jkern
from sadvio_tpu_torch.ops import klt_kernel as tkern

torch.set_num_threads(2)

H, W = 96, 320
R = 5
DX, DY = 1.7, -1.2


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    img = np.kron(rng.standard_normal((H // 4, W // 4)), np.ones((4, 4)))
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        img = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), ax, img)
    img0 = jnp.asarray((img - img.min()) / (img.max() - img.min()) * 200.0, jnp.float32)
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
                          indexing="ij")
    img1 = bilinear_sample(img0, jnp.stack([xs + DX, ys + DY], -1))
    return img0, img1


def _inputs(images, N, seed=1):
    img0, img1 = images
    rng = np.random.default_rng(seed)
    uv0 = jnp.asarray(np.stack([rng.uniform(80, 240, N), rng.uniform(40, 56, N)], -1),
                      jnp.float32)
    warp = jnp.broadcast_to(jnp.eye(2), (N, 2, 2))
    T, gx, gy, nrm, good = jklt._templates(img0, uv0, warp, R, 1e-3)
    return img1, uv0, T, gx, gy, nrm, np.asarray(good)


def _run_both(img1, uv_init, T, gx, gy, nrm, iters=12):
    j = np.asarray(jkern.lk_iterate(img1, uv_init, T, gx, gy, nrm, iters=iters, interpret=True))
    t = tkern.lk_iterate_ref(*[torch.as_tensor(np.array(x))
                               for x in (img1, uv_init, T, gx, gy, nrm)], iters=iters).numpy()
    return j, t


@pytest.mark.parametrize("N", [24, 37])
def test_ref_matches_pallas_interpret(images, N):
    """N=37 is not a multiple of the Pallas kernel's 8 features/program,
    so it also runs the JAX padding path."""
    img1, uv0, T, gx, gy, nrm, good = _inputs(images, N)
    j, t = _run_both(img1, uv0, T, gx, gy, nrm)
    assert good.sum() > 0.8 * N
    np.testing.assert_allclose(t[good, :2], j[good, :2], atol=1e-3)
    np.testing.assert_allclose(t[good, 2], j[good, 2], atol=1e-3)


def test_ref_recovers_the_true_shift(images):
    img1, uv0, T, gx, gy, nrm, good = _inputs(images, 24)
    out = tkern.lk_iterate(*[torch.as_tensor(np.array(x))
                             for x in (img1, uv0, T, gx, gy, nrm)], iters=12).numpy()
    err = np.linalg.norm(out[:, :2] - (np.asarray(uv0) - [DX, DY]), axis=-1)
    assert np.median(err[good]) < 0.1, np.median(err[good])


def test_nan_start_row_stays_nan_and_others_unaffected(images):
    img1, uv0, T, gx, gy, nrm, good = _inputs(images, 24)
    uv_nan = np.array(uv0)
    uv_nan[5] = np.nan
    j, t = _run_both(img1, jnp.asarray(uv_nan), T, gx, gy, nrm)
    assert np.isnan(t[5]).all() and np.isnan(j[5]).all()
    keep = good.copy()
    keep[5] = False
    np.testing.assert_allclose(t[keep], j[keep], atol=1e-3)


def test_early_exit_is_per_feature(images):
    """A feature whose step drops below eps stops; the others go on.  With
    eps large, every feature stops after its first step."""
    img1, uv0, T, gx, gy, nrm, good = _inputs(images, 24)
    args = [torch.as_tensor(np.array(x)) for x in (img1, uv0, T, gx, gy, nrm)]
    one = tkern.lk_iterate_ref(*args, iters=1).numpy()
    big_eps = tkern.lk_iterate_ref(*args, iters=12, eps=1e3).numpy()
    np.testing.assert_array_equal(big_eps, one)
