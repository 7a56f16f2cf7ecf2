"""Mesh densification of the port against the JAX package, on the textured
plane fixture of tests/test_mesh.py (made once with numpy, fed to both).

Tolerances, with reasons:
* Delaunay: both triangulate with the native library when it builds and
  with scipy otherwise; triangle *sets* are compared (two triangulators may
  order triangles and vertices differently);
* geometric and normal filters: identical masks (a non-planar, partly
  degenerate landmark set, so that every gate rejects something);
* ZNCC: identical masks for every triangle whose score is at least 1e-3 away
  from the threshold (the JAX package samples through a one-hot contraction,
  the port through gathers);
* ray cast: equal validity, points within 1e-4 m;
* ``Mesher.update``: the same surviving triangle set and clouds that agree
  point by point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.data.window import Rig as JRig, WindowState as JWindow
from sadvio_tpu.mesh import mesh as jmesh
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.pipeline.synthetic import render_view
from sadvio_tpu_torch.data.convert import from_numpy, slam_state_from_numpy
from sadvio_tpu_torch.mesh import mesh as tmesh

torch.set_num_threads(2)

W, H = 160, 120
T = lambda x: torch.as_tensor(np.array(x))
_cam = lambda rig, c: jax.tree.map(
    lambda x: x[c] if hasattr(x, "shape") and x.ndim > 0 else x, rig.cam)


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(11)
    model = jcam.Pinhole(fx=jnp.full((2,), 120.0), fy=jnp.full((2,), 120.0),
                         cx=jnp.full((2,), W / 2), cy=jnp.full((2,), H / 2), width=W, height=H)
    rig = JRig(cam=model, R_f_s=jnp.broadcast_to(jnp.eye(3), (2, 3, 3)),
               t_f_s=jnp.asarray([[0.0, 0.0, 0.0], [0.11, 0.0, 0.0]], jnp.float32))
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 6), np.linspace(-1.1, 1.1, 5))
    pts = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    pts += rng.uniform(-0.05, 0.05, pts.shape)
    lmk = np.concatenate([pts, np.full((len(pts), 1), 3.0)], -1).astype(np.float32)
    tex = np.stack([rng.uniform(-1.8, 1.8, 4000), rng.uniform(-1.4, 1.4, 4000),
                    np.full(4000, 3.0)], -1).astype(np.float32)
    inten = rng.uniform(1.5, 8.0, 4000).astype(np.float32)
    imgs = np.stack([np.asarray(render_view(
        jnp.float32(120.0), jnp.asarray([W / 2, H / 2], jnp.float32), jnp.eye(3), jnp.zeros(3),
        rig.R_f_s[c], rig.t_f_s[c], jnp.asarray(tex), jnp.asarray(inten), W, H))
        for c in range(2)])
    L = len(lmk)
    state = JWindow.create(2, L).replace(lmk=jnp.asarray(lmk), lmk_mask=jnp.ones((L,), bool),
                                         kf_mask=jnp.asarray([True, False]))
    uv = np.asarray(jcam.project_world(_cam(rig, 0), jnp.eye(3), jnp.zeros(3), rig.R_f_s[0],
                                       rig.t_f_s[0], state.lmk)[0])
    trig = from_numpy(jax.tree.map(np.asarray, rig), "cpu")
    tstate = from_numpy(jax.tree.map(np.asarray, state), "cpu")
    return dict(rig=rig, state=state, imgs=imgs, uv=uv, trig=trig, tstate=tstate, lmk=lmk)


def _pose(R, t):
    return (jnp.asarray(R), jnp.asarray(t)), (T(R), T(t))


def _tri_set(tri, mask):
    return {tuple(sorted(int(i) for i in row)) for row in np.asarray(tri)[np.asarray(mask)]}


def _triangles(plane, cap=128):
    tri, mask = jmesh.delaunay_triangles(plane["uv"], np.ones(len(plane["uv"]), bool), cap)
    return tri, mask


def test_delaunay_triangle_sets_equal(plane):
    valid = np.ones(len(plane["uv"]), bool)
    valid[[4, 17]] = False
    tj, mj = jmesh.delaunay_triangles(plane["uv"], valid, 128)
    tt, mt, n_total = tmesh.delaunay_triangles(plane["uv"], valid, 128)
    assert _tri_set(tt, mt) == _tri_set(tj, mj) and n_total == mt.sum() >= 30
    assert tt.dtype == np.int64 and not {4, 17} & {i for tr in _tri_set(tt, mt) for i in tr}
    # the cut at cap is counted, and fewer than three points give no triangle
    tc, mc, n_c = tmesh.delaunay_triangles(plane["uv"], valid, 10)
    assert mc.sum() == 10 and n_c == n_total
    assert tmesh.delaunay_triangles(plane["uv"], np.zeros(len(valid), bool), 16)[2] == 0


@pytest.mark.parametrize("max_edge", [1.5, 0.95])
def test_geometric_and_normal_filters_identical(plane, max_edge):
    rng = np.random.default_rng(5)
    tri, mask = _triangles(plane)
    lmk = plane["lmk"].copy()
    lmk[:, 2] += rng.uniform(-0.35, 0.35, len(lmk)).astype(np.float32)  # slanted triangles
    lmk[7, 2] = 12.0  # beyond the depth gate
    lmk[20, :2] = lmk[21, :2] + 0.01  # a sliver
    lmk_mask = np.ones(len(lmk), bool)
    lmk_mask[11] = False
    R = np.asarray(jgeo_exp([0.02, -0.03, 0.01]))
    t = np.asarray([0.05, -0.02, 0.1], np.float32)
    (Rj, tj), (Rt, tt) = _pose(R, t)
    rig, trig = plane["rig"], plane["trig"]
    cfgj = jmesh.MeshConfig(max_edge_len=max_edge)
    cfgt = tmesh.MeshConfig(max_edge_len=max_edge)
    assert cfgt == tuple(cfgj)
    mj = jmesh.filter_triangles(jnp.asarray(lmk), jnp.asarray(lmk_mask), jnp.asarray(tri),
                                jnp.asarray(mask), _cam(rig, 0), Rj, tj, rig.R_f_s[0],
                                rig.t_f_s[0], cfgj)
    mt = tmesh.filter_triangles(T(lmk), T(lmk_mask), T(tri).long(), T(mask), trig.cam.camera(0),
                                Rt, tt, trig.R_f_s[0], trig.t_f_s[0], cfgt)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < mt.sum() < mask.sum()
    for min_cos in (0.2, 0.9):
        nj = jmesh.normal_consistency(jnp.asarray(lmk), jnp.asarray(tri), mj, tj, min_cos)
        nt = tmesh.normal_consistency(T(lmk), T(tri).long(), mt, tt, min_cos)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.sum() < mt.sum()
    np.testing.assert_allclose(tmesh.triangle_normals(T(lmk), T(tri).long()).numpy(),
                               np.asarray(jmesh.triangle_normals(jnp.asarray(lmk),
                                                                 jnp.asarray(tri))), atol=1e-5)


def jgeo_exp(w):
    from sadvio_tpu.utils import geometry as jgeo

    return jgeo.so3_exp(jnp.asarray(w, jnp.float32))


@pytest.mark.parametrize("dz,tsh,half", [(0.0, 0.5, 5), (0.0, 0.8, 7), (-0.25, 0.5, 5),
                                          (-1.8, 0.5, 5)])
def test_zncc_masks_identical_off_threshold(plane, dz, tsh, half):
    tri, mask = _triangles(plane)
    lmk = plane["lmk"].copy()
    lmk[:, 2] += dz  # a wrong depth misregisters the warp
    rig, trig = plane["rig"], plane["trig"]
    eye, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    imgs = plane["imgs"]
    mj = jmesh.zncc_validate(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(lmk),
                             jnp.asarray(tri), jnp.asarray(mask), _cam(rig, 0), _cam(rig, 1),
                             jnp.eye(3), jnp.zeros(3), rig.R_f_s[0], rig.t_f_s[0], rig.R_f_s[1],
                             rig.t_f_s[1], tsh, half)
    args = (T(imgs[0]), T(imgs[1]), T(lmk), T(tri).long())
    cams = (trig.cam.camera(0), trig.cam.camera(1), T(eye), T(z), trig.R_f_s[0], trig.t_f_s[0],
            trig.R_f_s[1], trig.t_f_s[1])
    mt = tmesh.zncc_validate(*args, T(mask), *cams, tsh, half)
    score, frac, _ = tmesh.zncc_scores(*args, *cams, half)
    clear = ((score - tsh).abs() > 1e-3) & ((frac - 0.6).abs() > 1e-3)
    assert clear.sum() >= 0.9 * len(clear)
    np.testing.assert_array_equal(mt.numpy()[clear.numpy()], np.asarray(mj)[clear.numpy()])
    if dz == 0.0 and tsh == 0.5:
        assert mt.sum() > 0.6 * mask.sum()  # the right plane correlates
    if dz == -1.8:
        assert mt.sum() < 0.3 * mask.sum()  # the wrong one does not


@pytest.mark.parametrize("stride", [6, 4])
def test_raycast_points_and_validity_equal(plane, stride):
    tri, mask = _triangles(plane)
    rng = np.random.default_rng(3)
    lmk = plane["lmk"].copy()
    lmk[:, 2] += rng.uniform(-0.4, 0.4, len(lmk)).astype(np.float32)
    mask = mask & (rng.uniform(size=len(mask)) > 0.2)
    rig, trig = plane["rig"], plane["trig"]
    R = np.asarray(jgeo_exp([0.01, 0.02, -0.01]))
    t = np.asarray([0.03, 0.01, -0.05], np.float32)
    (Rj, tj), (Rt, tt) = _pose(R, t)
    kw = dict(stride=stride, height=H, width=W, min_depth=0.25, max_depth=3.3)
    pj, vj = jmesh.raycast_pointcloud(jnp.asarray(lmk), jnp.asarray(tri), jnp.asarray(mask),
                                      _cam(rig, 0), Rj, tj, rig.R_f_s[0], rig.t_f_s[0], **kw)
    pt, vt = tmesh.raycast_pointcloud(T(lmk), T(tri).long(), T(mask), trig.cam.camera(0), Rt, tt,
                                      trig.R_f_s[0], trig.t_f_s[0], **kw)
    vj = np.asarray(vj)
    # a pixel on a triangle's edge, or a depth at the window's end, may fall
    # either way in float32: at most 1% of the pixels, compared where both agree
    both = vt.numpy() & vj
    assert (vt.numpy() != vj).mean() <= 0.01 and both.sum() > 50 and (~vj).sum() > 50
    np.testing.assert_allclose(pt.numpy()[both], np.asarray(pj)[both], atol=1e-4)


def test_mesher_update_matches_and_carries_state(plane):
    from sadvio_tpu_torch.pipeline.config import SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    rig, state, trig, tstate = plane["rig"], plane["state"], plane["trig"], plane["tstate"]
    mj = jmesh.Mesher(rig, jmesh.MeshConfig(max_edge_len=1.5), tri_cap=128)
    mt = tmesh.Mesher(trig, tmesh.MeshConfig(max_edge_len=1.5), tri_cap=128)
    trij, maskj = mj.update(jnp.asarray(plane["imgs"]), state, jnp.eye(3), jnp.zeros(3))
    trit, maskt = mt.update(T(plane["imgs"]), tstate, torch.eye(3), torch.zeros(3))
    sj, st = _tri_set(trij, maskj), _tri_set(trit, maskt)
    assert len(st) > 10 and len(sj ^ st) <= 1  # at most one triangle at the ZNCC threshold
    assert mt.n_cut == 0 and mt.tri.device == tstate.lmk.device
    cj, ct = mj.dense_points(), mt.dense_points()
    assert len(ct) > 50 and abs(len(ct) - len(cj)) <= 0.02 * len(cj)
    np.testing.assert_allclose(ct[:, 2], 3.0, atol=0.05)
    # the mesher's triangles of a JAX run continue in a port pipeline
    slam = StereoSLAM(trig, SLAMConfig(mesh3d=True), device="cpu")
    slam_state_from_numpy(slam, mesh=(np.asarray(trij), np.asarray(maskj)))
    assert _tri_set(slam.mesher.tri, slam.mesher.tri_mask) == sj
    assert slam.mesher.tri.dtype == torch.int64
