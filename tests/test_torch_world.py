"""The port's synthetic world against the JAX package's.

Same seed, same draws: IMU samples, timestamps and ground truth must be
equal (both computed in float64 numpy); images are rendered by each
framework in float32 and must agree to 0.05 intensity (of 255).
"""

import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu_torch.pipeline import synthetic as tsyn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds():
    kw = dict(seed=3, n_frames=4, width=320, height=240, n_points=200, imu_noise=True)
    return jsyn.make_world(**kw), tsyn.make_world(**kw, device="cpu")


def test_ground_truth_and_imu_equal(worlds):
    wj, wt = worlds
    for name in ("gt_R", "gt_t", "gt_v", "points"):
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name), err_msg=name)
    assert len(wt.frames) == len(wj.frames)
    for fj, ft in zip(wj.frames, wt.frames):
        assert ft.ts == fj.ts
        for name in ("acc", "gyr", "dt"):
            np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))


def test_images_agree(worlds):
    wj, wt = worlds
    for fj, ft in zip(wj.frames, wt.frames):
        assert ft.images.shape == fj.images.shape == (2, 240, 320)
        np.testing.assert_allclose(ft.images, fj.images, atol=0.05)


def test_rig_and_imu_params_equal(worlds):
    wj, wt = worlds
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(wt.rig.cam, name).numpy(),
                                      np.asarray(getattr(wj.rig.cam, name)))
    np.testing.assert_array_equal(wt.rig.t_f_s.numpy(), np.asarray(wj.rig.t_f_s))
    for name in ("acc_noise", "gyr_noise", "acc_walk", "gyr_walk"):
        assert getattr(wt.imu_params, name) == pytest.approx(float(getattr(wj.imu_params, name)))


def test_ate_rmse_matches(worlds, rng):
    wj, _ = worlds
    est = wj.gt_t + rng.standard_normal(wj.gt_t.shape) * 0.01
    for scale in (False, True):
        assert tsyn.ate_rmse(est, wj.gt_t, with_scale=scale) == pytest.approx(
            jsyn.ate_rmse(est, wj.gt_t, with_scale=scale), rel=1e-12)


@pytest.fixture(scope="module")
def excursion_worlds():
    """The loop-closure world: the excursion trajectory along a wider wall."""
    kw = dict(seed=11, n_frames=5, width=320, height=240, n_points=420, imu_noise=True,
              noise_px=1.0, trajectory="excursion", wall_x=(-5.0, 11.0))
    return jsyn.make_world(**kw), tsyn.make_world(**kw, device="cpu")


def test_excursion_ground_truth_and_imu_equal(excursion_worlds):
    wj, wt = excursion_worlds
    for name in ("gt_R", "gt_t", "gt_v", "points"):
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name), err_msg=name)
    assert wt.points[:, 0].max() > 10.0  # the wall reaches out to wall_x[1]
    for fj, ft in zip(wj.frames, wt.frames):
        assert ft.ts == fj.ts
        for name in ("acc", "gyr", "dt"):
            np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))


def test_excursion_images_agree(excursion_worlds):
    """Same noise draws on both sides, so the noisy images agree as the clean ones do."""
    wj, wt = excursion_worlds
    for fj, ft in zip(wj.frames, wt.frames):
        np.testing.assert_allclose(ft.images, fj.images, atol=0.05)


def test_excursion_returns_to_the_start():
    w = tsyn.make_world(seed=0, n_frames=40, width=64, height=48, n_points=30,
                        trajectory="excursion", device="cpu")
    x = w.gt_t[:, 0]
    assert x.max() > 2.1 and abs(x[0]) < 1e-6 and x[-1] < 0.2 and np.argmax(x) in (19, 20, 21)


@pytest.fixture(scope="module", params=["fisheye", "double_sphere", "omni"])
def exotic_worlds(request):
    """The exotic-camera worlds: splat centres placed by each model."""
    kw = dict(seed=13, n_frames=3, width=320, height=240, n_points=200, imu_noise=True,
              camera=request.param)
    return jsyn.make_world(**kw), tsyn.make_world(**kw, device="cpu")


def test_exotic_world_matches(exotic_worlds):
    wj, wt = exotic_worlds
    assert type(wt.rig.cam).__name__ == type(wj.rig.cam).__name__
    for name in wj.rig.cam.__dataclass_fields__:
        a, b = getattr(wt.rig.cam, name), getattr(wj.rig.cam, name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            assert a == b, name
    for name in ("gt_R", "gt_t", "gt_v", "points"):
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name), err_msg=name)
    for fj, ft in zip(wj.frames, wt.frames):
        for name in ("acc", "gyr", "dt"):
            np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
        np.testing.assert_allclose(ft.images, fj.images, atol=0.05)


@pytest.fixture(scope="module")
def nofov_worlds():
    """The scale-recovery world of tests/test_nofov_pipeline.py, 4 frames."""
    kw = dict(seed=6, n_frames=4, width=320, height=240, n_points=200, rot_scale=1.5, lever=1.5)
    return jsyn.make_nofov_world(**kw), tsyn.make_nofov_world(**kw, device="cpu")


def test_nofov_world_matches(nofov_worlds):
    wj, wt = nofov_worlds
    np.testing.assert_array_equal(wt.rig.R_f_s.numpy(), np.asarray(wj.rig.R_f_s))
    np.testing.assert_array_equal(wt.rig.t_f_s.numpy(), np.asarray(wj.rig.t_f_s))
    assert wt.rig.t_f_s[1, 0] == 1.5 and wt.rig.R_f_s[1, 2, 2] < -0.99  # looks back
    for name in ("gt_R", "gt_t", "gt_v", "points"):
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name), err_msg=name)
    for fj, ft in zip(wj.frames, wt.frames):
        assert ft.ts == fj.ts and len(ft.dt) == len(fj.dt) == 0
        assert ft.images.shape == fj.images.shape == (2, 240, 320)
        np.testing.assert_allclose(ft.images, fj.images, atol=0.05)
    for c in range(2):  # both walls are seen
        assert wt.frames[0].images[c].mean() > 5.0

