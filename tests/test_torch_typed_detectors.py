"""The port's typed detectors against the JAX package's: edgelets, coded
ellipses, semantic boxes, csv keypoints and the descriptor zoo.

Inputs are the JAX tests' scenes (tests/test_edgelets.py,
test_ellipses.py, test_bbox.py, test_csv_keypoints.py,
test_descriptors.py).  Tolerances, with reasons:
* integer outputs (labels, IDs, matches, masks): identical;
* edgelet grid positions: the same valid count and, per grid cell, the same
  sorted scores within 1e-4 relative; the positions themselves may differ
  where a rendered line gives a cell several pixels of equal score that
  the two convolutions round one unit apart (measured: 38 of 52 valid
  positions agree, the rest are such ties); where the positions agree the
  tangents agree to 1e-4;
* ellipse axes: 0.1 px (measured 0.063 px): the JAX package sums the
  second moments of a blob in float32, with rounding error at ~1e8, the
  port sums them exactly (integers in float64), and the central moments
  cancel; its axes come out closer to the drawn radius (29.97 against
  29.94 for 30 px).  For the same reason the marker angle: 0.05 rad
  (measured 0.025): a near-circle's ellipse angle is ill-conditioned, and
  on the drawn circles the port reads the drawn angle to 1e-5 rad where the
  JAX package is 0.013-0.025 rad off;
* float outputs of closed-form float32 math: 1e-4 relative or 1e-3 px /
  1e-4 m (measured <= 3e-5);
* pattern poses: 1e-3 (measured 3.7e-4), and the port's within 1e-4 of
  the true pose (measured 5e-6): the port runs the two small SVDs in
  float64, the JAX package in float32 (3.7e-4 off the truth);
* ORB and BRISK bits on a smooth random texture: >= 98% of the features
  within 2 of their bits (a bit flips where the two compared samples are
  equal to float32 rounding; measured 100% within 0 bits); DoH scores 1e-4
  relative (measured 2.4e-6).  On the blocky textures of
  tests/test_descriptors.py whole pairs fall in one flat block, their two
  samples tie exactly, and the smoothing's rounding decides the bit: there
  the bits are compared only through the JAX tests' own gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import bbox as jbbox, csv_keypoints as jcsv, descriptors as jdsc
from sadvio_tpu.frontend import edgelets as jedge, ellipses as jell
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.data.convert import unpack_descriptors
from sadvio_tpu_torch.frontend import bbox as tbbox, csv_keypoints as tcsv, descriptors as tdsc
from sadvio_tpu_torch.frontend import edgelets as tedge, ellipses as tell
from sadvio_tpu_torch.models import cameras as tcam
from tests.test_ellipses import _canvas, _render_pattern, render_marker
from tests.test_lines import render_segments

torch.set_num_threads(2)

T = torch.as_tensor


def _n(x):
    return np.asarray(x)


# -- edgelets --------------------------------------------------------------


def test_edgelets_match():
    segs = [((30.0, 50.0), (200.0, 70.0)), ((120.0, 20.0), (130.0, 160.0))]
    img = render_segments(segs, thickness=1.2)
    out_j = [_n(x) for x in jedge.detect_edgelets(jnp.asarray(img), gh=6, gw=8, k_per_cell=4)]
    out_t = [x.numpy() for x in tedge.detect_edgelets(T(img), gh=6, gw=8, k_per_cell=4)]
    np.testing.assert_array_equal(out_t[3], out_j[3])
    v = out_j[3]
    assert v.sum() >= 20
    np.testing.assert_allclose(np.sort(out_t[2].reshape(48, 4), 1),
                               np.sort(out_j[2].reshape(48, 4), 1), rtol=1e-4)
    same = v & (out_t[0] == out_j[0]).all(-1)
    assert same.sum() >= 0.6 * v.sum()
    np.testing.assert_allclose(out_t[1][same], out_j[1][same], atol=1e-4)

    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.arange(5) * 40.0 + 20, np.arange(6) * 40.0 + 20)
    uv_a = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
    ang = rng.uniform(0, np.pi, 30)
    dir_a = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ones = np.ones(30, bool)
    for dir_b in (dir_a, np.stack([-dir_a[:, 1], dir_a[:, 0]], -1)):
        ij, _ = jax.jit(jedge.match_edgelets)(uv_a, dir_a, ones, uv_a + 3.0, dir_b, ones)
        it, _ = tedge.match_edgelets(T(uv_a), T(dir_a), T(ones), T(uv_a + 3.0), T(dir_b), T(ones))
        np.testing.assert_array_equal(it.numpy(), _n(ij))


def _two_views():
    R_b = np.asarray(jgeo.so3_exp(jnp.asarray([0.01, -0.03, 0.02], jnp.float32)))
    return (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), R_b,
            np.asarray([0.25, 0.05, 0.0], np.float32))


def test_triangulate_edgelet_matches():
    jc = jcam.make_pinhole(150.0, 150.0, 120.0, 90.0, 240, 180)
    tc = tcam.make_pinhole(150.0, 150.0, 120.0, 90.0, 240, 180)
    p = np.asarray([[0.3, -0.2, 4.0], [-0.5, 0.4, 5.0]], np.float32)
    d = np.asarray([[0.8, 0.1, 0.59], [0.0, 0.97, 0.26]], np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    R_a, t_a, R_b, t_b = _two_views()
    obs = []
    for R, t in ((R_a, t_a), (R_b, t_b)):
        args = [jnp.asarray(x) for x in (R, t, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
        uv0, _ = jcam.project_world(jc, *args, jnp.asarray(p))
        uv1, _ = jcam.project_world(jc, *args, jnp.asarray(p + 0.05 * d))
        dd = _n(uv1 - uv0)
        obs += [_n(uv0), dd / np.linalg.norm(dd, axis=-1, keepdims=True)]
    pj, dj, okj = jax.jit(lambda *a: jedge.triangulate_edgelet(jc, jc, *a))(
        R_a, t_a, R_b, t_b, *obs)
    pt, dt, okt = tedge.triangulate_edgelet(tc, tc, *[T(x) for x in (R_a, t_a, R_b, t_b, *obs)])
    np.testing.assert_array_equal(okt.numpy(), _n(okj))
    assert okt.all()
    np.testing.assert_allclose(pt.numpy(), _n(pj), atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), _n(dj), atol=1e-4)


# -- coded ellipses --------------------------------------------------------


def _marker_images():
    imgs = {"circle": render_marker(_canvas(), (140.0, 150.0), 30.0, payload=7),
            "rotated": render_marker(_canvas(), (200.0, 230.0), 28.0, payload=3, o=24),
            "oblique": render_marker(_canvas(), (240.0, 200.0), 30.0, payload=9, ba=0.7,
                                     theta=np.deg2rad(30.0))}
    imgs["pattern"] = _render_pattern(_canvas(520, 520), (330.0, 330.0), 25.0, pattern_id=30)[0]
    return {k: v.astype(np.float32) for k, v in imgs.items()}


@pytest.fixture(scope="module")
def marker_images():
    return _marker_images()


@pytest.mark.parametrize("name", ["circle", "rotated", "oblique", "pattern"])
def test_ellipse_detection_matches(marker_images, name):
    img = marker_images[name]
    fg_j = _n(jell.binarize_dark(jnp.asarray(img)))
    fg_t = tell.binarize_dark(T(img))
    np.testing.assert_array_equal(fg_t.numpy(), fg_j)
    lab_t, steps = tell.connected_components(fg_t, return_steps=True)
    np.testing.assert_array_equal(lab_t.numpy(), _n(jax.jit(jell.connected_components)(fg_j)))
    assert 0 < steps < 512
    dj = {k: _n(v) for k, v in jell.detect_coded_ellipses(jnp.asarray(img)).items()}
    dt = {k: v.numpy() for k, v in tell.detect_coded_ellipses(T(img)).items()}
    np.testing.assert_array_equal(dt["valid"], dj["valid"])
    v = dj["valid"]
    assert v.sum() >= 1
    np.testing.assert_array_equal(dt["id"][v], dj["id"][v])
    np.testing.assert_allclose(dt["center"][v], dj["center"][v], atol=1e-3)
    np.testing.assert_allclose(dt["axes"][v], dj["axes"][v], atol=0.1)
    np.testing.assert_allclose(dt["theta"][v], dj["theta"][v], atol=0.05)
    drawn = {"circle": -np.pi / 2, "rotated": -24 * 2 * np.pi / 128 - np.pi / 2}
    if name in drawn:
        np.testing.assert_allclose(dt["theta"][v], drawn[name], atol=1e-5)
    if name == "pattern":
        gj = [_n(x) for x in jell.group_patterns_4({k: jnp.asarray(x) for k, x in dj.items()})]
        gt = [x.numpy() for x in tell.group_patterns_4({k: T(x) for k, x in dt.items()})]
        np.testing.assert_array_equal(gt[2], gj[2])
        assert gj[2].sum() == 1
        np.testing.assert_array_equal(gt[1][gj[2]], gj[1][gj[2]])
        np.testing.assert_allclose(gt[0][gj[2]], gj[0][gj[2]], atol=1e-3)


def test_match_patterns_and_pose_match():
    ids_a, ids_b = np.asarray([30, 12, 7]), np.asarray([7, 30, 99])
    va, vb = np.asarray([True, False, True]), np.ones(3, bool)
    ij, okj = jell.match_patterns(*[jnp.asarray(x) for x in (ids_a, va, ids_b, vb)])
    it, okt = tell.match_patterns(*[T(x) for x in (ids_a, va, ids_b, vb)])
    np.testing.assert_array_equal(okt.numpy(), _n(okj))
    np.testing.assert_array_equal(it.numpy()[_n(okj)], _n(ij)[_n(okj)])

    K = np.asarray([[300.0, 0.0, 240.0], [0.0, 300.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    rng = np.random.default_rng(1)
    uv4, Rs, ts = [], [], []
    for _ in range(4):
        R = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
        t = np.asarray([rng.normal(0, 0.1), rng.normal(0, 0.1), rng.uniform(1.5, 3.0)])
        xyz = np.concatenate([jell.MODEL_CORNERS * 0.4, np.zeros((4, 1))], -1)
        pc = xyz @ R.T + t
        uv = pc @ K.T
        uv4.append(uv[:, :2] / uv[:, 2:3])
        Rs.append(R)
        ts.append(t)
    uv4 = np.asarray(uv4, np.float32)
    Rj, tj = jax.jit(jax.vmap(lambda q: jell.pattern_pose(jnp.asarray(K), q, 0.4)))(uv4)
    Rt, tt = tell.pattern_pose(T(K), T(uv4), 0.4)
    np.testing.assert_allclose(Rt.numpy(), _n(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), _n(tj), atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rs), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(ts), atol=1e-4)


# -- boxes -----------------------------------------------------------------


def test_bbox_functions_match():
    a = np.asarray([[[10.0, 10.0], [50.0, 50.0]], [[100.0, 100.0], [140.0, 160.0]],
                    [[0.0, 0.0], [1.0, 1.0]]], np.float32)
    b = np.asarray([[[102.0, 104.0], [141.0, 158.0]], [[12.0, 8.0], [52.0, 49.0]]], np.float32)
    la, lb = np.asarray([1, 2, 3]), np.asarray([2, 1])
    va, vb = np.asarray([True, True, False]), np.asarray([True, True])
    np.testing.assert_allclose(tbbox.iou_matrix(T(a), T(b)).numpy(),
                               _n(jbbox.iou_matrix(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    for lab_b in (lb, np.asarray([9, 9])):
        ij, okj = jbbox.match_bboxes(*[jnp.asarray(x) for x in (a, la, va, b, lab_b, vb)])
        it, okt = tbbox.match_bboxes(*[T(x) for x in (a, la, va, b, lab_b, vb)])
        np.testing.assert_array_equal(okt.numpy(), _n(okj))
        np.testing.assert_array_equal(it.numpy()[_n(okj)], _n(ij)[_n(okj)])

    mk = lambda m, x: m(fx=x(300.0), fy=x(300.0), cx=x(240.0), cy=x(240.0), width=480, height=480)
    jc = mk(jcam.Pinhole, lambda v: jnp.asarray(v, jnp.float32))
    tc = mk(tcam.Pinhole, lambda v: torch.tensor(v))
    center = np.asarray([[0.3, -0.2, 5.0], [-0.5, 0.4, 7.0]], np.float32)
    scale = np.asarray([[0.6, 0.8, 0.8], [1.0, 0.5, 0.5]], np.float32)
    valid = np.ones(2, bool)
    eye, t_a, t_b = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.asarray(
        [0.8, 0.0, 0.0], np.float32)
    views = []
    for t in (t_a, t_b):
        bj, okj = jax.jit(lambda *a: jbbox.project_box(jc, *a))(eye, t, center, scale, valid)
        bt, okt = tbbox.project_box(tc, *[T(x) for x in (eye, t, center, scale, valid)])
        np.testing.assert_allclose(bt.numpy(), _n(bj), atol=1e-3)
        np.testing.assert_array_equal(okt.numpy(), _n(okj))
        views.append((_n(bj), _n(okj)))
    (ba_, oa), (bb, ob) = views
    pj, sj, okj = jax.jit(lambda *a: jbbox.triangulate_bbox(jc, *a))(ba_, oa, eye, t_a, bb, ob,
                                                                     eye, t_b)
    pt, st, okt = tbbox.triangulate_bbox(tc, *[T(x) for x in (ba_, oa, eye, t_a, bb, ob, eye,
                                                              t_b)])
    np.testing.assert_array_equal(okt.numpy(), _n(okj))
    np.testing.assert_allclose(pt.numpy(), _n(pj), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), _n(sj), atol=1e-4)
    R = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    p_s, t = np.asarray([[1.0, 0.0, 0.0]], np.float32), np.asarray([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(
        tbbox.pose_from_provider((T(R), T(t)), T(p_s), T(np.ones(1, bool)))[0].numpy(),
        _n(jbbox.pose_from_provider((jnp.asarray(R), jnp.asarray(t)), jnp.asarray(p_s),
                                    jnp.ones(1, bool))[0]), atol=1e-6)


# -- csv keypoints ---------------------------------------------------------


def test_csv_keypoints_match(tmp_path):
    from tests.test_csv_keypoints import _write_csv

    rng = np.random.default_rng(3)
    uvs = rng.uniform(0, 400, (20, 2)).round(2)
    _write_csv(tmp_path / "1403636579763555584.csv", uvs, rng.integers(0, 255, (20, 128)))
    (tmp_path / "7.csv").write_text("u,v\n[1.0, 2.0]\n[3, 4], [5]\n")  # short rows are skipped
    for ts, kw in ((1403636579763555584, dict(capacity=32)), (7, dict(capacity=4, desc_dim=0)),
                   (7, dict(capacity=4, desc_dim=1)), (42, dict(capacity=8))):
        jo = jcsv.load_csv_keypoints(str(tmp_path), ts, **kw)
        to = tcsv.load_csv_keypoints(str(tmp_path), ts, device="cpu", **kw)
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a.numpy(), _n(b))
    if not torch.cuda.is_available():  # device=None means the card, as at the entry points
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcsv.load_csv_keypoints(str(tmp_path), 7)
    uv, desc, valid = [_n(x) for x in jcsv.load_csv_keypoints(str(tmp_path), 1403636579763555584,
                                                              capacity=32)]
    perm = rng.permutation(20)
    desc_b = np.vstack([desc[:20][perm], np.zeros((12, 128), np.float32)])
    uv_b = np.vstack([uv[:20][perm], np.zeros((12, 2), np.float32)])
    valid_b = np.asarray([True] * 20 + [False] * 12)
    for kw in ({}, {"search_px": 5.0}):
        ij, okj = jcsv.match_csv_keypoints(*[jnp.asarray(x) for x in (desc, valid, desc_b, valid_b,
                                                                      uv, uv_b)], **kw)
        it, okt = tcsv.match_csv_keypoints(*[T(x) for x in (desc, valid, desc_b, valid_b, uv, uv_b)],
                                           **kw)
        np.testing.assert_array_equal(okt.numpy(), _n(okj))
        np.testing.assert_array_equal(it.numpy()[_n(okj)], _n(ij)[_n(okj)])
        assert okt.sum() >= 20 * (kw == {})


# -- descriptors -----------------------------------------------------------


@pytest.fixture(scope="module")
def texture():
    """Random intensities under a 5x5 box blur: no flat areas."""
    rng = np.random.default_rng(4)
    raw = rng.uniform(0.0, 255.0, (164, 164))
    img = sum(raw[i:i + 160, j:j + 160] for i in range(5) for j in range(5)) / 25.0
    return img.astype(np.float32), rng.uniform(20.0, 140.0, (64, 2)).astype(np.float32)


def _within_2_bits(bits_t, words_j):
    ham = (bits_t.numpy() != unpack_descriptors(words_j).numpy()).sum(-1)
    return np.mean(ham <= 2)


def test_orientation_and_orb_match(texture):
    img, uv = texture
    th_j = _n(jax.jit(jdsc.orientation)(jnp.asarray(img), jnp.asarray(uv)))
    th_t = tdsc.orientation(T(img), T(uv)).numpy()
    np.testing.assert_allclose(th_t, th_j, atol=1e-4)
    orb_j = _n(jax.jit(jdsc.orb_describe)(jnp.asarray(img), jnp.asarray(uv)))
    orb_t = tdsc.orb_describe(T(img), T(uv))
    assert orb_t.shape == (64, 256) and orb_t.dtype == torch.bool
    assert _within_2_bits(orb_t, orb_j) >= 0.98


def test_brisk_and_hessian_match(texture):
    img, uv = texture
    br_j = _n(jax.jit(jdsc.brisk_describe)(jnp.asarray(img), jnp.asarray(uv)))
    br_t = tdsc.brisk_describe(T(img), T(uv))
    assert br_t.shape == (64, 512)
    assert _within_2_bits(br_t, br_j) >= 0.98
    hj = _n(jdsc.hessian_score(jnp.asarray(img)))
    ht = tdsc.hessian_score(T(img)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-4 * np.abs(hj).max())


def test_descriptors_pass_the_jax_gates_on_blocky_texture():
    """tests/test_descriptors.py's gates on the port: ORB under a 35 degree
    rotation (mean Hamming < 70 of 256, below unoriented BRIEF's), BRISK's
    nearest neighbour under 25 degrees, the DoH peak on a Gaussian blob."""
    from sadvio_tpu_torch.frontend.detect import brief_describe, smooth3
    from tests.test_descriptors import _rotate_image, _texture

    def rotated(pts, deg, c):
        th = np.deg2rad(deg)
        p = pts - c
        return np.stack([np.cos(th) * p[:, 0] - np.sin(th) * p[:, 1],
                         np.sin(th) * p[:, 0] + np.cos(th) * p[:, 1]], -1) + c

    img = _texture()
    uv = np.asarray([[80.0, 80.0], [70.0, 90.0], [95.0, 75.0]], np.float32)
    img_r = _rotate_image(img, 35.0, (80.0, 80.0))
    uv_r = rotated(uv, 35.0, 80.0).astype(np.float32)
    ham = (tdsc.orb_describe(T(img), T(uv)) != tdsc.orb_describe(T(img_r), T(uv_r))).sum(-1)
    b0 = brief_describe(smooth3(T(img)), T(uv))
    b1 = brief_describe(smooth3(T(img_r)), T(uv_r))
    assert ham.float().mean() < 70 and (b0 != b1).sum(-1).float().mean() > ham.float().mean()

    img = _texture(seed=5)
    pts = np.asarray([[60.0, 60.0], [100.0, 70.0], [75.0, 105.0], [90.0, 95.0]], np.float32)
    d0 = tdsc.brisk_describe(T(img), T(pts))
    d1 = tdsc.brisk_describe(T(_rotate_image(img, 25.0, (80.0, 80.0))),
                             T(rotated(pts, 25.0, 80.0).astype(np.float32)))
    D = (d0[:, None, :] != d1[None, :, :]).sum(-1)
    assert torch.equal(D.argmin(1), torch.arange(4))

    ys, xs = np.mgrid[0:96, 0:96]
    blob = (200.0 * np.exp(-(((xs - 30) ** 2 + (ys - 40) ** 2) / (2 * 4.0 ** 2)))).astype(np.float32)
    v, u = np.unravel_index(tdsc.hessian_score(T(blob)).numpy().argmax(), (96, 96))
    assert abs(u - 30) <= 2 and abs(v - 40) <= 2
