"""The port's line features against the JAX package's: detection, dedup,
matching, clipping, triangulation and the reprojection residual.

Tolerances, with reasons:
* detect_lines on the scene of tests/test_line_channel.py, on a noisy
  render of tests/test_lines.py's segments and on a 320x240 frame of the
  starved line world: the same valid set, endpoints within 0.1 px, strength
  within 1e-4 relative (the Hough accumulator is a fixed-point sum in the
  port, a float32 scatter in the JAX package; measured 7.6e-5 px and
  7.1e-7); dedup and matching: identical;
* clipping, triangulation and residuals: 1e-4 (float32 closed forms;
  measured 3.0e-5).
The Hough vote is the same on every call: two detections of one image are
bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import lines as jlines
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.frontend import lines as tlines
from sadvio_tpu_torch.models import cameras as tcam
from tests.test_line_channel import SEGS3D, _project_seg, _render
from tests.test_lines import SEGS, render_segments

torch.set_num_threads(2)

T = torch.as_tensor


def _images():
    rig = jsyn.make_rig(320, 240, baseline=0.5)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    noisy = render_segments(SEGS) + np.random.default_rng(0).uniform(0, 20, (180, 240))
    world = jsyn.make_world(seed=7, n_frames=1, width=320, height=240, n_points=20, n_lines=12,
                            imu_noise=False)
    return {"scene": _render([_project_seg(rig, 0, R, t, seg) for seg in SEGS3D]),
            "noisy": noisy.astype(np.float32), "starved_world": world.frames[0].images[1]}


@pytest.fixture(scope="module")
def detections():
    out = {}
    for name, img in _images().items():
        out[name] = ([np.asarray(x) for x in jlines.detect_lines(jnp.asarray(img), n_lines=24)],
                     [x.numpy() for x in tlines.detect_lines(T(img), n_lines=24)], img)
    return out


@pytest.mark.parametrize("case", ["scene", "noisy", "starved_world"])
def test_detect_and_dedup_match(detections, case):
    (ej, sj, vj), (et, st, vt), img = detections[case]
    np.testing.assert_array_equal(vt, vj)
    assert vj.sum() >= 3
    np.testing.assert_allclose(et[vj], ej[vj], atol=0.1)
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-3)
    dj = np.asarray(jlines.dedup_lines(jnp.asarray(ej), jnp.asarray(vj), jnp.asarray(sj)))
    dt = tlines.dedup_lines(T(et), T(vt), T(st)).numpy()
    np.testing.assert_array_equal(dt, dj)
    again = tlines.detect_lines(T(img), n_lines=24)
    assert all(torch.equal(a, T(b)) for a, b in zip(again, (et, st, vt)))


def test_match_lines_matches(detections):
    """Detections of one render against a shifted render (tests/test_lines.py)."""
    (ea, _, va), _, _ = detections["noisy"]
    shift = [((x0 + 8, y0 + 3), (x1 + 8, y1 + 3)) for (x0, y0), (x1, y1) in SEGS]
    eb, _, vb = [np.asarray(x) for x in jlines.detect_lines(jnp.asarray(render_segments(shift)),
                                                            n_lines=24)]
    for kw in ({}, dict(max_midpoint_px=25.0, max_angle_deg=6.0, min_overlap=0.5)):
        ij, sj = jlines.match_lines(*[jnp.asarray(x) for x in (ea, va, eb, vb)], **kw)
        it, st = tlines.match_lines(*[T(x) for x in (ea, va, eb, vb)], **kw)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert (it >= 0).sum() >= 3
        ok = np.isfinite(np.asarray(sj))
        np.testing.assert_allclose(st.numpy()[ok], np.asarray(sj)[ok], atol=1e-4)


def test_clip_triangulate_and_residual_match():
    rng = np.random.default_rng(2)
    a = rng.uniform(-100, 400, (64, 2)).astype(np.float32)
    b = rng.uniform(-100, 400, (64, 2)).astype(np.float32)
    b[:4, 0] = a[:4, 0]  # vertical segments: the parallel branch
    out_j = jlines.clip_segment_to_image(jnp.asarray(a), jnp.asarray(b), 320.0, 240.0)
    out_t = tlines.clip_segment_to_image(T(a), T(b), 320.0, 240.0)
    ok = np.asarray(out_j[2])
    np.testing.assert_array_equal(out_t[2].numpy(), ok)
    for x, y in zip(out_t[:2], out_j[:2]):
        np.testing.assert_allclose(x.numpy()[ok], np.asarray(y)[ok], atol=1e-3)

    jc = jcam.make_pinhole(150.0, 150.0, 120.0, 90.0, 240, 180)
    tc = tcam.make_pinhole(150.0, 150.0, 120.0, 90.0, 240, 180)
    p0 = rng.uniform([-1.0, -0.6, 3.5], [1.0, 0.6, 6.0], (16, 3)).astype(np.float32)
    p1 = (p0 + rng.normal(0, 0.6, (16, 3))).astype(np.float32)
    R_b = np.asarray(jgeo.so3_exp(jnp.asarray([0.02, -0.04, 0.01], jnp.float32)))
    t_b = np.asarray([0.3, 0.05, 0.0], np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

    def ends(R, t):
        uv = [np.asarray(jcam.project_world(jc, *map(jnp.asarray, (R, t, eye, zero, p)))[0])
              for p in (p0, p1)]
        return np.stack(uv, 1) + rng.normal(0, 0.3, (16, 2, 2)).astype(np.float32)

    ends_a, ends_b = ends(eye, zero), ends(R_b, t_b)
    for cond in (0.2, 0.0):
        qj = jlines.triangulate_line(jc, jc, *map(jnp.asarray, (eye, zero, R_b, t_b, ends_a,
                                                                ends_b)), cond_min=cond)
        qt = tlines.triangulate_line(tc, tc, *map(T, (eye, zero, R_b, t_b, ends_a, ends_b)),
                                     cond_min=cond)
        okj = np.asarray(qj[2])
        np.testing.assert_array_equal(qt[2].numpy(), okj)
        assert okj.sum() >= 8
        for x, y in zip(qt[:2], qj[:2]):
            np.testing.assert_allclose(x.numpy()[okj], np.asarray(y)[okj], atol=1e-4)
    for kw in ({}, dict(sigma_px=2.0, w_along=0.5)):
        rj, vj = jlines.line_reproj_residual(jc, *map(jnp.asarray, (R_b, t_b, eye, zero, p0, p1,
                                                                   ends_b)), **kw)
        rt, vt = tlines.line_reproj_residual(tc, *map(T, (R_b, t_b, eye, zero, p0, p1, ends_b)),
                                             **kw)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
