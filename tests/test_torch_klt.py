"""Template building, pyramidal tracking and detection of the port against
the JAX package.

Tolerances: templates 1e-4 relative (plus 1e-4 absolute for near-zero
gradients) -- same bilinear arithmetic in float32, except the normal
matrix's cross term b = sum gx gy, which cancels and is held to 1e-5 of
sqrt(a c); full tracks: the same
valid mask and median |duv| < 0.05 px against the JAX gather engine, which
runs a fixed iteration count where the port stops at eps = 0.01 px;
detection: identical slots (integer pixel positions, same tie order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import detect as jdet, klt as jklt
from sadvio_tpu.frontend.detect import bilinear_sample
from sadvio_tpu_torch.frontend import detect as tdet, klt as tklt

torch.set_num_threads(2)

H, W = 96, 320
R = 5


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def textured():
    rng = np.random.default_rng(7)
    img = np.kron(rng.standard_normal((H // 4, W // 4)), np.ones((4, 4)))
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        img = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), ax, img)
    return jnp.asarray((img - img.min()) / (img.max() - img.min()) * 200.0, jnp.float32)


def _shift(img, dx, dy):
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
                          indexing="ij")
    return bilinear_sample(img, jnp.stack([xs + dx, ys + dy], -1))


@pytest.mark.parametrize("warped", [False, True])
def test_templates_match(textured, rng, warped):
    N = 40
    uv0 = np.stack([rng.uniform(4, W - 4, N), rng.uniform(4, H - 4, N)], -1).astype(np.float32)
    warp = np.broadcast_to(np.eye(2, dtype=np.float32), (N, 2, 2)).copy()
    if warped:  # scale/shear warps within the det gate, features near the edges too
        warp = warp * rng.uniform(0.7, 1.4, (N, 1, 1)) + rng.uniform(-0.2, 0.2, (N, 2, 2))
        warp = warp.astype(np.float32)
    j = jklt._templates(textured, jnp.asarray(uv0), jnp.asarray(warp), R, 1e-3)
    t = tklt._templates(_t(textured), _t(uv0), _t(warp), R, 1e-3)
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    nj, nt = np.asarray(j[3], np.float64), t[3].numpy()
    np.testing.assert_allclose(nt[:, [0, 2]], nj[:, [0, 2]], rtol=1e-4)
    # b = sum gx gy cancels: its error scales with sqrt(a c), not with b
    scale = np.sqrt(nj[:, 0] * nj[:, 2])
    assert (np.abs(nt[:, 1] - nj[:, 1]) <= 1e-5 * scale + 1e-4).all()
    np.testing.assert_allclose(nt[:, 3], nj[:, 3], rtol=1e-3)
    np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))


def test_full_track_matches_gather_engine(textured):
    """Fixture of tests/test_klt_kernel.py:99-120: 3 levels, a (5.5, -3.25)
    px shift recovered from a zero initial guess, fb-checked."""
    dx, dy = 5.5, -3.25
    img1 = _shift(textured, dx, dy)
    rng = np.random.default_rng(4)
    N = 24
    uv0 = np.stack([rng.uniform(80, 240, N), rng.uniform(40, 56, N)], -1).astype(np.float32)
    valid0 = np.ones(N, bool)
    uv_j, v_j, _ = jklt.track(jklt.build_pyramid(textured, 3), jklt.build_pyramid(img1, 3),
                              jnp.asarray(uv0), jnp.asarray(uv0), jnp.asarray(valid0),
                              levels=3, radius=R, engine="gather")
    uv_t, v_t, _ = tklt.track(tklt.build_pyramid(_t(textured), 3),
                              tklt.build_pyramid(_t(img1), 3), _t(uv0), _t(uv0), _t(valid0),
                              levels=3, radius=R)
    v = np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v)
    assert v.sum() > 0.7 * N
    d = np.linalg.norm(uv_t.numpy() - np.asarray(uv_j), axis=-1)
    assert np.median(d[v]) < 0.05, np.median(d[v])
    e = np.linalg.norm(uv_t.numpy() - (uv0 - [dx, dy]), axis=-1)
    assert np.median(e[v]) < 0.15


def test_pyramid_levels_match(textured):
    """Level values agree on the true (unpadded) extent of each level."""
    pj = jklt.build_pyramid(textured, 4)
    pt = tklt.build_pyramid(_t(textured), 4)
    for lvl, (h, w) in enumerate(tklt.pyramid_dims((H, W), 4)):
        assert tuple(pt[lvl].shape) == (h, w)
        np.testing.assert_allclose(pt[lvl].numpy(), np.asarray(pj[lvl])[:h, :w], atol=1e-4)


@pytest.fixture(scope="module")
def world_frame():
    from sadvio_tpu.pipeline import synthetic

    world = synthetic.make_world(seed=3, n_frames=2, width=320, height=240, n_points=200)
    return world.frames[1].images[0]


@pytest.mark.parametrize("existing", [False, True])
def test_detect_features_matches(world_frame, existing):
    img = world_frame
    kw = dict(gh=8, gw=10, k_per_cell=5)
    ex_j = ex_t = {}
    if existing:
        rng = np.random.default_rng(2)
        uv = np.stack([rng.uniform(0, 320, 60), rng.uniform(0, 240, 60)], -1).astype(np.float32)
        val = rng.uniform(size=60) < 0.7
        ex_j = dict(existing_uv=jnp.asarray(uv), existing_valid=jnp.asarray(val))
        ex_t = dict(existing_uv=_t(uv), existing_valid=_t(val))
    uj, sj, vj = jdet.detect_features(jnp.asarray(img), **ex_j, **kw)
    ut, st, vt = tdet.detect_features(_t(img), **ex_t, **kw)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert vj.sum() > 50
    np.testing.assert_array_equal(ut.numpy()[vj], np.asarray(uj)[vj])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-4)


def test_smooth_and_bilinear_match(world_frame, rng):
    img = world_frame
    np.testing.assert_allclose(tdet.smooth3(_t(img)).numpy(),
                               np.asarray(jdet.smooth3(jnp.asarray(img))), atol=1e-3)
    uv = np.stack([rng.uniform(-5, 330, 100), rng.uniform(-5, 250, 100)], -1).astype(np.float32)
    np.testing.assert_allclose(tdet.bilinear_sample(_t(img), _t(uv)).numpy(),
                               np.asarray(jdet.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))),
                               atol=1e-3)
