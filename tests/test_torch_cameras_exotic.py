"""The port's double-sphere, fisheye and omni camera models against the JAX
package's, on the same seeded numpy points.

Models: the exotic cases of tests/test_cameras.py (scalar parameters) and
the synthetic rigs of ``make_rig(camera=...)`` ((C,) parameters picked by
``camera(c)``).  Tolerances: pixels 1e-3 px, rays 1e-5, point and
world-chain Jacobians 1e-4 relative to their norm (``torch.func.jacfwd``
against ``jax.jacfwd``, float32); validity masks identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.models import cameras as tcam
from sadvio_tpu_torch.pipeline import synthetic as tsyn

torch.set_num_threads(2)

PX_TOL, RAY_TOL, JAC_REL = 1e-3, 1e-5, 1e-4
NAMES = ["ds", "fisheye", "omni"]


def _jax_models():
    f32 = jnp.float32
    return {
        "ds": jcam.DoubleSphere(f32(364.0), f32(364.0), f32(376.0), f32(240.0), f32(0.57),
                                f32(-0.18)),
        "fisheye": jcam.Fisheye(f32(380.0), f32(380.0), f32(376.0), f32(240.0),
                                f32(0.01), f32(-0.002), f32(0.001), f32(-0.0005)),
        "omni": jcam.Omni(f32(480.0), f32(480.0), f32(376.0), f32(240.0), f32(0.8),
                          f32(0.01), f32(-0.005), f32(0.0002), f32(-0.0001)),
    }


def _pair(name):
    jm = _jax_models()[name]
    return jm, from_numpy(jax.tree.map(np.asarray, jm))


def _points(seed, n=128):
    """The points of tests/test_cameras.py plus wide-angle ones (up to ~70 deg)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3)) * np.array([0.4, 0.3, 0.0]) + np.array([0.0, 0.0, 3.0])
    p[:, 2] += rng.uniform(0.5, 5.0, n)
    wide = np.stack([rng.uniform(-2.5, 2.5, n // 4), rng.uniform(-2.0, 2.0, n // 4),
                     rng.uniform(0.8, 2.0, n // 4)], -1)
    return np.concatenate([p, wide]).astype(np.float32)


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_project_matches(name):
    jm, tm = _pair(name)
    p = _points(1)
    uv_j, v_j = jm.project(jnp.asarray(p))
    uv_t, v_t = tm.project(torch.as_tensor(p))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.asarray(v_j).sum() > 100
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=PX_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_backproject_matches(name):
    jm, tm = _pair(name)
    uv_j, v_j = jm.project(jnp.asarray(_points(2)))
    uv = np.asarray(uv_j)[np.asarray(v_j)]
    ray_j = np.asarray(jm.backproject(jnp.asarray(uv)))
    ray_t = tm.backproject(torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(ray_t, ray_j, atol=RAY_TOL)
    # and the round trip closes on the port side alone
    p = _points(2)[np.asarray(v_j)]
    np.testing.assert_allclose(ray_t, p / np.linalg.norm(p, axis=-1, keepdims=True), atol=2e-3)


@pytest.mark.parametrize("name", NAMES)
def test_point_jacobian_matches(name):
    """jacfwd under vmap on both sides, at every point (masked or not)."""
    jm, tm = _pair(name)
    p = _points(3)
    _, J_j, _ = jm.project_jac(jnp.asarray(p))
    uv_t, J_t, _ = tm.project_jac(torch.as_tensor(p))
    assert J_t.shape == (len(p), 2, 3)
    for i in range(0, len(p), 7):
        assert _rel(J_t[i].numpy(), J_j[i]) < JAC_REL, i
    # the batched Jacobian keeps the leading dims of the points
    _, J_b, _ = tm.project_jac(torch.as_tensor(p[:12].reshape(3, 4, 3)))
    np.testing.assert_allclose(J_b.reshape(12, 2, 3).numpy(), J_t[:12].numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_point_jacobian_against_differences(name):
    """The port's autodiff Jacobian against central differences in float64."""
    _, tm = _pair(name)
    tm64 = tm.replace(**{k: v.double() for k, v in vars(tm).items()
                         if isinstance(v, torch.Tensor)})
    p = torch.as_tensor(_points(4)[:16], dtype=torch.float64)
    _, J, _ = tm64.project_jac(p)
    eps = 1e-6
    for k in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[k] = eps
        fd = (tm64.project(p + e)[0] - tm64.project(p - e)[0]) / (2 * eps)
        np.testing.assert_allclose(J[:, :, k].numpy(), fd.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("camera", ["fisheye", "double_sphere", "omni"])
def test_rig_world_chain_matches(camera):
    """The synthetic rig of each model: camera(c) pick, project_world_jac and
    bearing_world over a window of poses against the JAX world chain."""
    jrig = jsyn.make_rig(320, 240, camera=camera)
    trig = tsyn.make_rig(320, 240, camera=camera, device="cpu")
    rng = np.random.default_rng(7)
    K, L = 3, 40
    w = (rng.standard_normal((K, 3)) * 0.1).astype(np.float32)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    t = (rng.standard_normal((K, 3)) * 0.2).astype(np.float32)
    p = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(3, 8, L)], -1).astype(np.float32)
    for c in range(2):
        jc = jax.tree.map(lambda x: x[c] if hasattr(x, "ndim") and x.ndim > 0 else x, jrig.cam)
        tc = trig.cam.camera(c)
        assert type(tc).__name__ == type(jc).__name__
        args_j = (jnp.asarray(R)[:, None], jnp.asarray(t)[:, None], jrig.R_f_s[c],
                  jrig.t_f_s[c], jnp.asarray(p)[None])
        args_t = (torch.as_tensor(R)[:, None], torch.as_tensor(t)[:, None], trig.R_f_s[c],
                  trig.t_f_s[c], torch.as_tensor(p)[None])
        uv_j, Jp_j, Jl_j, v_j = jcam.project_world_jac(jc, *args_j)
        uv_t, Jp_t, Jl_t, v_t = tcam.project_world_jac(tc, *args_t)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=PX_TOL)
        assert _rel(Jp_t.numpy(), Jp_j) < JAC_REL and _rel(Jl_t.numpy(), Jl_j) < JAC_REL
        ray_j = jcam.bearing_world(jc, args_j[0], args_j[1], args_j[2], args_j[3], uv_j)
        ray_t = tcam.bearing_world(tc, args_t[0], args_t[1], args_t[2], args_t[3], uv_t)
        np.testing.assert_allclose(ray_t.numpy(), np.asarray(ray_j), atol=RAY_TOL)


def test_from_numpy_carries_each_model():
    for name in NAMES:
        jm, tm = _pair(name)
        assert type(tm).__name__ == type(jm).__name__
        for f in jm.__dataclass_fields__:
            a, b = getattr(tm, f), getattr(jm, f)
            if isinstance(a, torch.Tensor):
                assert a.dtype == torch.float32 and float(a) == float(b), f
            else:
                assert a == b, f
    assert set(tcam.MODELS) == {"pinhole", "fisheye", "double_sphere", "omni"}
