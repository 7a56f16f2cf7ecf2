"""The port's synthetic world with IMU biases and the hardening knobs
against the JAX package's.

Same seed, same draws: each knob draws its random numbers in the JAX
package's order (the flicker per camera after both views are rendered,
then the pixel noise, then the IMU noise), so IMU samples must be equal,
biases included (added in float32 after the float32 noise, in float64
without it, as the JAX package adds them).  Images are rendered by each
framework in float32 and agree to the clean world's 0.05 intensity
(tests/test_torch_world.py) scaled by the largest flicker gain, 1.12:
0.06.
"""

import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu_torch.pipeline import synthetic as tsyn

torch.set_num_threads(2)

IMG_ATOL = 0.06
GYR_BIAS = np.array([0.02, -0.015, 0.01])  # tests/test_pipeline_stress.py's biases
ACC_BIAS = np.array([0.05, 0.04, -0.06])
BASE = dict(n_frames=5, width=320, height=240, n_points=200)
CASES = {
    "bias_noisy_imu": dict(seed=5, imu_noise=True, rot_scale=4.0, acc_bias=ACC_BIAS,
                           gyr_bias=GYR_BIAS),
    "bias_clean_imu": dict(seed=5, imu_noise=False, acc_bias=ACC_BIAS, gyr_bias=GYR_BIAS),
    "gyr_bias_only": dict(seed=2, imu_noise=True, gyr_bias=GYR_BIAS.astype(np.float32)),
    "flicker": dict(seed=9, gain_jitter=0.12, offset_jitter=8.0),
    "occluder": dict(seed=9, occluder=True),
    "hardened": dict(seed=9, imu_noise=True, noise_px=2.0, gain_jitter=0.12, offset_jitter=8.0,
                     occluder=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def worlds(request):
    kw = {**BASE, **CASES[request.param]}
    return request.param, jsyn.make_world(**kw), tsyn.make_world(**kw, device="cpu")


def test_imu_and_ground_truth_equal(worlds):
    _, wj, wt = worlds
    for name in ("gt_R", "gt_t", "gt_v", "points"):
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name), err_msg=name)
    for fj, ft in zip(wj.frames, wt.frames, strict=True):
        assert ft.ts == fj.ts
        for name in ("acc", "gyr", "dt"):
            a, b = getattr(ft, name), getattr(fj, name)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_images_agree(worlds):
    _, wj, wt = worlds
    for fj, ft in zip(wj.frames, wt.frames, strict=True):
        assert ft.images.shape == fj.images.shape == (2, 240, 320)
        assert ft.images.dtype == np.float32
        np.testing.assert_allclose(ft.images, fj.images, atol=IMG_ATOL)


def test_knobs_take_effect(worlds):
    """Against the world without the case's knobs: the biases shift every
    IMU sample by exactly the bias (up to float32 rounding), the flicker
    changes each camera's exposure, the occluder is a 12.0 disc of radius
    0.12 W at make_world's centre, and the pixel noise is there."""
    name, _, wt = worlds
    kw = {**BASE, **CASES[name]}
    knobs = ("acc_bias", "gyr_bias", "gain_jitter", "offset_jitter", "occluder", "noise_px")
    plain = tsyn.make_world(**{k: v for k, v in kw.items() if k not in knobs}, device="cpu")
    W, H, T = BASE["width"], BASE["height"], BASE["n_frames"]
    for k, (fp, ft) in enumerate(zip(plain.frames, wt.frames, strict=True)):
        for field, bias in (("acc", kw.get("acc_bias")), ("gyr", kw.get("gyr_bias"))):
            if bias is not None and k > 0 and "noise_px" not in kw:
                np.testing.assert_allclose(getattr(ft, field) - getattr(fp, field),
                                           np.broadcast_to(bias, getattr(ft, field).shape),
                                           atol=1e-5)
        if kw.get("occluder") and "noise_px" not in kw:
            ys, xs = np.mgrid[0:H, 0:W]
            cx, cy = (k / (T - 1)) * (W + 120.0) - 60.0, H * (0.5 + 0.3 * np.sin(0.5 * k))
            disc = (xs - cx) ** 2 + (ys - cy) ** 2 < (0.12 * W) ** 2
            if disc.any():
                assert (ft.images[:, disc] == 12.0).all()
        if "noise_px" in kw:
            assert np.std(ft.images - fp.images) > 1.0
        if kw.get("gain_jitter") and "noise_px" not in kw:
            assert not np.allclose(ft.images, fp.images, atol=1.0)
            assert ft.images.min() >= 0.0 and ft.images.max() <= 255.0
