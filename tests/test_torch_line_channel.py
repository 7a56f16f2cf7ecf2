"""The port's line channel against the JAX package's.

Scene of tests/test_line_channel.py: three 3D segments rendered into a
wide-baseline stereo rig at five keyframe poses.  Both channels get the
same images and poses.  Tolerances, with reasons:
* slots, masks, ages and observation masks: identical (the decisions are
  gates on sub-pixel quantities far from their thresholds);
* endpoints: 1e-3 m after the standalone Gauss-Newton (float32, different
  reduction order; measured 1.3e-4 m), observed segments 1e-2 px
  (measured 4.6e-5 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sadvio_tpu.pipeline.channels  # noqa: F401  (before any trace: it builds bbox.CUBE)
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.line_channel import LineChannel as JLineChannel
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline.line_channel import LineChannel as TLineChannel
from tests.test_line_channel import SEGS3D, _project_seg, _render

torch.set_num_threads(2)

POSES = [(0.0, 0.0, 0.0), (0.25, 0.1, 0.0), (0.5, 0.0, 0.15), (0.3, -0.15, 0.1),
         (0.6, 0.1, 0.2)]


@pytest.fixture(scope="module")
def scene():
    rig = jsyn.make_rig(320, 240, baseline=0.5)
    frames = []
    for t in POSES:
        R, t = np.eye(3, dtype=np.float32), np.asarray(t, np.float32)
        imgs = [_render([_project_seg(rig, c, R, t, seg) for seg in SEGS3D]) for c in range(2)]
        frames.append((imgs, R, t))
    return rig, frames


def _state(ch, to_np):
    return {k: to_np(getattr(ch, k)) for k in ("p0", "p1", "mask", "age", "obs_ends", "obs_mask")}


def _compare(sj, st):
    for k in ("mask", "age", "obs_mask"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    m = sj["mask"]
    for k in ("p0", "p1"):
        np.testing.assert_allclose(st[k][m], sj[k][m], atol=1e-3, err_msg=k)
    np.testing.assert_allclose(st["obs_ends"], sj["obs_ends"], atol=1e-2)


@pytest.mark.parametrize("in_ba", [False, True])
def test_channel_matches_keyframe_by_keyframe(scene, in_ba):
    """Standalone (ring buffer + fixed-pose Gauss-Newton) and in-BA
    (window-slot rows, no refinement, the BA block handed out)."""
    rig, frames = scene
    kw = dict(n_slots=16, n_detect=12, window=4, in_ba=in_ba, k_window=6 if in_ba else None)
    jc = JLineChannel(rig, **kw)
    tc = TLineChannel(from_numpy(jax.tree.map(np.asarray, rig), "cpu"), **kw)
    for k, (imgs, R, t) in enumerate(frames):
        if in_ba:
            hj = jc.on_keyframe_pre_ba(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                                       jnp.asarray(R), jnp.asarray(t), k)
            ht = tc.on_keyframe_pre_ba(torch.as_tensor(imgs[0]), torch.as_tensor(imgs[1]),
                                       torch.as_tensor(R), torch.as_tensor(t), k)
        else:
            hj = jc.on_keyframe(None, jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                                jnp.asarray(R), jnp.asarray(t))
            ht = tc.on_keyframe(None, torch.as_tensor(imgs[0]), torch.as_tensor(imgs[1]),
                                torch.as_tensor(R), torch.as_tensor(t))
        assert ht == hj, k
        _compare(_state(jc, np.asarray), _state(tc, lambda x: x.numpy()))
    assert hj["n_lines"] >= 3 and hj["n_lines_tracked"] >= 2
    if in_ba:
        bj, bt = jc.ba_block(), tc.ba_block()
        for k in ("mask", "probation", "obs_mask"):
            np.testing.assert_array_equal(getattr(bt, k).numpy(), np.asarray(getattr(bj, k)))
        assert bt.mask.sum() >= 3
    else:
        # the JAX test's gate on the port's map: every true line recovered
        seg_map = tc.segments()
        for seg in SEGS3D:
            d = seg[1] - seg[0]
            d = d / np.linalg.norm(d)

            def dist(p):
                r = p - seg[0]
                return np.linalg.norm(r - (r @ d) * d)

            assert min(max(dist(s[0]), dist(s[1])) for s in seg_map) < 0.15


def test_roll_gauge_and_clear(scene):
    rig, frames = scene
    tc = TLineChannel(from_numpy(jax.tree.map(np.asarray, rig), "cpu"), n_slots=16, n_detect=12,
                      in_ba=True, k_window=6)
    for k, (imgs, R, t) in enumerate(frames[:3]):
        tc.on_keyframe_pre_ba(torch.as_tensor(imgs[0]), torch.as_tensor(imgs[1]),
                              torch.as_tensor(R), torch.as_tensor(t), k)
    rows = tc.obs_mask.clone()
    tc.on_roll()
    assert torch.equal(tc.obs_mask[:-1], rows[1:]) and not tc.obs_mask[-1].any()
    p0 = tc.p0.clone()
    Rz = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    tc.gauge_transform(Rz, 2.0)
    torch.testing.assert_close(tc.p0, 2.0 * p0 @ Rz.T)
    tc.clear()
    assert not tc.mask.any() and not tc.obs_mask.any() and len(tc.segments()) == 0
