"""The port's feature channels against the JAX package's, and its pipeline
under every features_handled label of tests/test_channels.py.

World of tests/test_channels.py (seed 11, 24 frames, 320x240, 200 blobs).
* claim_slots: the JAX test's regression, and identical output to the JAX
  allocator on inputs full of equal ages (stable sorts on both sides);
* each channel fed the same keyframes (images and ground-truth poses) in
  both packages: identical health counts, slot masks, ages, pattern IDs
  and labels; pattern poses and edgelet directions within 1e-3 (measured
  2.1e-4); stereo-triangulated positions and box scales within 2% of their
  depth (measured 0.72%): a 0.11 m baseline at 5 m turns 0.01 px of
  disparity into 5 mm of depth, and the near-parallel rays' 3x3 midpoint
  solve rounds differently in the two packages;
  halfway the port's channel is replaced by a fresh one that takes the JAX
  channel's state (``slam_state_from_numpy(channels=...)``) and goes on;
* the pipeline runs of the port (edgelet, ellipse pattern, provider boxes,
  csv keypoints) under the JAX tests' gates.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sadvio_tpu.pipeline.channels as jch
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu_torch.data.convert import from_numpy, slam_state_from_numpy
from sadvio_tpu_torch.pipeline import channels as tch
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.config import Capacities, FeatureConfig, SLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM
from tests.test_channels import _stamp_pattern

torch.set_num_threads(2)

KEYFRAMES = (0, 6, 12, 18)


def chan_config(extra_feature=None, features=None):
    feats = features or ((FeatureConfig(),) + ((extra_feature,) if extra_feature else ()))
    return SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                      max_movement_parallax=1.0, min_movement_parallax=0.02, features=feats,
                      caps=Capacities(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))


@pytest.fixture(scope="module")
def world():
    w = jsyn.make_world(seed=11, n_frames=24, width=320, height=240, n_points=200,
                        imu_noise=False)
    return w, from_numpy(jax.tree.map(np.asarray, w.rig), "cpu")


def test_claim_slots_spawns_while_slots_active():
    """tests/test_channels.py's regression: active slots sort last."""
    stale = torch.tensor([False, False, False, True, True])
    age = torch.tensor([0, 1, 2, 7, 9])
    tgt, src, do = tch.claim_slots(stale, torch.tensor([True, True, False, False]), age)
    claimed = tgt[do]
    assert int(do.sum()) == 2 and set(claimed.tolist()) == {3, 4} and claimed[0] == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claim_slots_matches_with_ties(seed):
    rng = np.random.default_rng(seed)
    stale = rng.uniform(size=32) < 0.6
    age = rng.integers(0, 4, 32)
    fresh = rng.uniform(size=24) < 0.5
    out_j = jch.claim_slots(jnp.asarray(stale), jnp.asarray(fresh), jnp.asarray(age, jnp.int32))
    out_t = tch.claim_slots(torch.as_tensor(stale), torch.as_tensor(fresh), torch.as_tensor(age))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def pattern(world):
    return _pattern_frames(world[0])


def _pattern_frames(w):
    """Camera-0 images of the first 16 frames with a coded 4-marker pattern
    (ID 9, side 1 m) fixed at a world anchor, as tests/test_channels.py
    stamps it."""
    anchor = np.array([1.2, 0.6, 5.0])
    corners = [anchor, anchor + [-1.0, 0.0, 0.0], anchor + [0.0, -1.0, 0.0],
               anchor + [-1.0, -1.0, 0.0]]
    cam0 = jax.tree.map(lambda x: x[0] if np.ndim(x) > 0 else x, w.rig.cam)
    return anchor, [f._replace(images=np.stack([_stamp_pattern(
        f.images[0], cam0, w.gt_R[i], w.gt_t[i], w.rig, corners, 1.0, pattern_id=9),
        f.images[1]])) for i, f in enumerate(w.frames[:16])]


def _box_detections(w, rig_np, i):
    """Both cameras' 2D boxes of a 0.8 m cube at (-1, 0.4, 5.5)."""
    corners = np.array([-1.0, 0.4, 5.5]) + np.array(
        [[a, b, c] for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)], np.float64) * 0.4
    boxes, valid = [], []
    for c in range(2):
        cam_c = jax.tree.map(lambda x, c=c: x[c] if np.ndim(x) > 0 else x, rig_np.cam)
        uv, vis = jcam.project_world(cam_c, jnp.asarray(w.gt_R[i]), jnp.asarray(w.gt_t[i]),
                                     rig_np.R_f_s[c], rig_np.t_f_s[c],
                                     jnp.asarray(corners, jnp.float32))
        uv = np.asarray(uv)
        boxes.append(np.stack([uv.min(0), uv.max(0)])[None])
        valid.append([bool(np.asarray(vis).all())])
    return {"boxes": np.stack(boxes), "labels": np.zeros((2, 1), np.int32),
            "valid": np.asarray(valid)}


class _BoxFrame:
    def __init__(self, f, det):
        self.ts, self.images, self.acc, self.gyr, self.dt = f.ts, f.images, f.acc, f.gyr, f.dt
        self.bboxes = det


def _channel_states(kind, ch, to_np):
    fields = {"edgelet": ("p", "d", "mask", "age"),
              "ellipse": ("pid", "R_w_p", "t_w_p", "mask", "age"),
              "bbox": ("center", "scale", "label", "mask", "age")}[kind]
    return {k: to_np(getattr(ch, k)) for k in fields}


@pytest.mark.parametrize("kind", ["edgelet", "ellipse", "bbox"])
def test_channel_matches_keyframe_by_keyframe(world, pattern, kind):
    w, rig = world
    if kind == "edgelet":
        jc, tc = jch.EdgeletChannel(w.rig), tch.EdgeletChannel(rig)
        frames = [w.frames[i] for i in KEYFRAMES]
    elif kind == "ellipse":
        jc, tc = jch.EllipseChannel(w.rig), tch.EllipseChannel(rig)
        frames = [pattern[1][i] for i in KEYFRAMES[:3]]
    else:
        jc, tc = jch.BBoxChannel(w.rig), tch.BBoxChannel(rig)
        frames = [_BoxFrame(w.frames[i], _box_detections(w, w.rig, i)) for i in KEYFRAMES]
    idx = [KEYFRAMES[j] for j in range(len(frames))]
    for n, (f, i) in enumerate(zip(frames, idx)):
        if n == 2:  # hand the JAX channel's state to a fresh port channel
            tc = type(tc)(rig)
            state = {k: np.asarray(v) for k, v in _channel_states(kind, jc, np.asarray).items()}
            slam_state_from_numpy(SimpleNamespace(device=torch.device("cpu"), channels=[tc]),
                                  channels=[state])
        R, t = w.gt_R[i], w.gt_t[i]
        hj = jc.on_keyframe(f, jnp.asarray(f.images[0]), jnp.asarray(f.images[1]),
                            jnp.asarray(R), jnp.asarray(t))
        ht = tc.on_keyframe(f, torch.as_tensor(f.images[0]), torch.as_tensor(f.images[1]),
                            torch.as_tensor(R), torch.as_tensor(t))
        assert ht == hj
        sj = _channel_states(kind, jc, np.asarray)
        st = _channel_states(kind, tc, lambda x: x.numpy())
        m = sj["mask"]
        for k in sj:
            if sj[k].dtype.kind in "biu":
                np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
            elif k in ("p", "center", "scale"):
                depth = np.abs(sj["p" if k == "p" else "center"][m][:, 2:3])
                assert (np.abs(st[k][m] - sj[k][m]) <= 0.02 * depth).all(), k
            else:
                np.testing.assert_allclose(st[k][m], sj[k][m], atol=1e-3, err_msg=k)
    assert m.sum() >= 1


def _port_run(cfg, rig, frames, **kw):
    slam = StereoSLAM(rig, cfg, device="cpu", **kw)
    out = {}
    for f in frames:
        out.update(slam.process_frame(f))
    return slam, out


def test_edgelet_channel_in_pipeline(world):
    w, rig = world
    slam, out = _port_run(chan_config(FeatureConfig(label="edgeletxd")), rig, w.frames)
    chan = [c for c in slam.channels if isinstance(c, tch.EdgeletChannel)][0]
    p, d = chan.points()
    assert out.get("n_edgelets", 0) >= 5 and len(p) >= 5, out
    assert np.mean((p[:, 2] > 2.5) & (p[:, 2] < 11.0)) > 0.6
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-3)


def test_ellipse_channel_in_pipeline(world, pattern):
    _, rig = world
    anchor, frames = pattern
    cfg = chan_config(FeatureConfig(label="ellipsepatternxd", pattern_side=1.0))
    slam, out = _port_run(cfg, rig, frames)
    pid, _, t_w_p = [c for c in slam.channels if isinstance(c, tch.EllipseChannel)][0].patterns()
    assert out.get("n_patterns", 0) >= 1 and 9 in pid.tolist(), out
    assert np.linalg.norm(t_w_p[pid.tolist().index(9)] - anchor) < 0.5


def test_bbox_channel_in_pipeline(world):
    """Boxes from a provider built from the ground truth, as the reference's
    provider contract gives them."""
    w, rig = world
    ts_to_i = {f.ts: i for i, f in enumerate(w.frames)}
    cfg = chan_config(FeatureConfig(label="bboxxd"))
    slam = StereoSLAM(rig, cfg, device="cpu")
    chan = [c for c in slam.channels if isinstance(c, tch.BBoxChannel)][0]
    chan.provider = lambda ts: _box_detections(w, w.rig, ts_to_i[ts])
    out = {}
    for f in w.frames[:16]:
        out.update(slam.process_frame(f))
    centers, scales, _ = chan.boxes()
    assert out.get("n_boxes", 0) >= 1 and len(centers) >= 1, out
    err = np.linalg.norm(centers - np.array([-1.0, 0.4, 5.5]), axis=-1)
    assert err.min() < 0.4
    assert 0.4 * 0.8 < scales[np.argmin(err)][0] < 2.5 * 0.8


def test_csv_detector_in_pipeline(world, tmp_path):
    """Precomputed keypoints (ground-truth projections) replace the detector;
    the run holds the JAX test's ATE gate."""
    w, rig = world
    cam0 = jax.tree.map(lambda x: x[0] if np.ndim(x) > 0 else x, w.rig.cam)
    for i, f in enumerate(w.frames):
        uv, vis = jcam.project_world(cam0, jnp.asarray(w.gt_R[i]), jnp.asarray(w.gt_t[i]),
                                     w.rig.R_f_s[0], w.rig.t_f_s[0],
                                     jnp.asarray(w.points, jnp.float32))
        rows = ["u, v, desc"] + [f"[{u:.2f}, {v:.2f}], [{', '.join(['0.0'] * 8)}]"
                                 for (u, v), ok in zip(np.asarray(uv), np.asarray(vis)) if ok]
        (tmp_path / f"{int(round(f.ts * 1e9))}.csv").write_text("\n".join(rows))
    cfg = chan_config(features=(FeatureConfig(label="pointxd", detector="csv",
                                              folder=str(tmp_path)),))
    slam = StereoSLAM(rig, cfg, device="cpu")
    assert slam._use_csv and not slam.channels
    est = slam.run(w.frames)
    assert tsyn.ate_rmse(est, w.gt_t[: len(est)]) < 0.05
    assert len(slam.kf_traj) >= 2
    # a stamp within 1 ms finds its file; without one the slots are empty
    uv, v = slam._csv_det(w.frames[3]._replace(ts=w.frames[3].ts + 4e-4))
    assert v.any() and uv.device.type == "cpu"
    assert not slam._csv_det(w.frames[3]._replace(ts=w.frames[3].ts + 0.01))[1].any()


def test_ignored_labels_and_refused_keys(world):
    """Labels the JAX package does not dispatch are ignored; no key is
    refused any more: ``async_health`` builds (its state starts empty),
    ``multithreading`` builds the back-end executor, and the mono class
    takes typed labels and builds, as the JAX package's does with one
    camera, only the ellipse channel."""
    from sadvio_tpu.pipeline.mono import MonoSLAM as JMono
    from sadvio_tpu_torch.pipeline.mono import MonoSLAM

    w, rig = world
    feats = (FeatureConfig(), FeatureConfig(label="pointxd", detector="shi_tomasi"),
             FeatureConfig(label="planexd"))
    slam = StereoSLAM(rig, chan_config(features=feats), device="cpu")
    assert not slam.channels and not slam._use_csv
    slam = StereoSLAM(rig, dataclasses.replace(chan_config(), multithreading=True), device="cpu")
    assert slam.backend_exec is not None
    slam = StereoSLAM(rig, dataclasses.replace(chan_config(), async_health=True), device="cpu")
    assert slam.cfg.async_health and slam._health_pend is None and slam._last_health is None
    feats = tuple(FeatureConfig(label=lb) for lb in ("pointxd", "linexd", "edgeletxd",
                                                    "ellipsepatternxd", "bboxxd"))
    cfg = dataclasses.replace(chan_config(features=feats), slam_mode="mono")
    mono = MonoSLAM(rig.subset([0]), cfg, device="cpu")
    jrig = w.rig.replace(cam=jax.tree.map(lambda x: x[:1] if np.ndim(x) > 0 else x, w.rig.cam),
                         R_f_s=w.rig.R_f_s[:1], t_f_s=w.rig.t_f_s[:1])
    names = lambda s: [type(c).__name__ for c in s.channels]
    assert names(mono) == names(JMono(jrig, cfg)) == ["EllipseChannel"]
    assert mono._line_ch is None