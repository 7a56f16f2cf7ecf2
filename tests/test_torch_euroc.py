"""The port's EuRoC provider, image enhancers and rig_from_dataset against the JAX
package's.

Inputs are made once with numpy.  The sequence is the synthetic world of
tests/test_run_euroc.py (seed 6, 24 frames, 320x240) written in the EuRoC
layout by ``euroc.write_sequence``.

Tolerances: CLAHE, histogram equalization, AGCWD and remap within 1e-3
intensity (float32 either way; the histograms are exact counts in both);
rigs leaf by leaf within 1e-7 (the same float64 -> float32 casts);
provider frames bit-equal with no enhancement, within one uint8 level with
CLAHE or with undistortion (a value within 1e-3 of an integer can truncate
to either side); stamps and IMU batches bit-equal (the same float64 parse).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import config as jcfg, euroc as jeuroc, synthetic as jsyn
from sadvio_tpu_torch.pipeline import config as tcfg, euroc as teuroc

torch.set_num_threads(2)

INTENSITY_TOL = 1e-3
RIG_TOL = 1e-7

CALIB = dict(width=96, height=64, T_f_s=tuple(np.eye(4).reshape(-1).tolist()))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    low = rng.uniform(20, 120, (64, 96)).astype(np.float32)  # a low-contrast image
    world = jsyn.make_world(seed=6, n_frames=2, width=320, height=240, n_points=200)
    frame = np.clip(world.frames[1].images[0], 0, 255).astype(np.uint8).astype(np.float32)
    return {"low": low, "frame": frame}


@pytest.mark.parametrize("method", ["clahe", "histeq", "agcwd"])
@pytest.mark.parametrize("which", ["low", "frame"])
def test_enhancers_match_jax(images, method, which):
    img = images[which]
    j = np.asarray(jeuroc.enhance_contrast(jnp.asarray(img), method))
    t = teuroc.enhance_contrast(torch.as_tensor(img), method).numpy()
    assert t.shape == j.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=INTENSITY_TOL, rtol=0)
    assert teuroc.enhance_contrast(torch.as_tensor(img), "none") is not None


def test_remap_matches_jax(images):
    calib = jcfg.CameraCalib(model="pinhole", intrinsics=(90.0, 88.0, 47.0, 31.5),
                             distortion=(-0.28, 0.07, 2e-4, -1e-4), **CALIB)
    grid_j, intr_j = jeuroc.undistort_grid(calib)
    grid_t, intr_t = teuroc.undistort_grid(calib)
    np.testing.assert_array_equal(grid_t, grid_j)
    assert intr_t == intr_j
    img = images["low"]
    j = np.asarray(jeuroc.remap(jnp.asarray(img), jnp.asarray(grid_j)))
    t = teuroc.remap(torch.as_tensor(img), torch.as_tensor(grid_t)).numpy()
    np.testing.assert_allclose(t, j, atol=INTENSITY_TOL, rtol=0)


CALIBS = {
    "pinhole": ((200.0, 201.0, 160.0, 120.0), (0.01, -0.002, 0.0, 0.0)),
    "fisheye": ((240.0, 240.0, 160.0, 120.0, 0.02, -0.005), (0.0, 0.0, 0.001, 0.0)),
    "double_sphere": ((230.0, 231.0, 160.0, 120.0, -0.2, 0.55), ()),
    "omni": ((360.0, 360.0, 160.0, 120.0, 0.8), (-0.01, 0.002, 0.0, 1e-4)),
}


@pytest.mark.parametrize("model", sorted(CALIBS))
def test_rig_from_dataset_matches_jax(model):
    intr, dist = CALIBS[model]
    T1 = np.eye(4)
    T1[:3, 3] = (0.11, 0.002, -0.001)
    cams = tuple(tcfg.CameraCalib(model=model, intrinsics=intr, distortion=dist, width=320,
                                  height=240, T_f_s=tuple(T.reshape(-1).tolist()))
                 for T in (np.eye(4), T1))
    ds_t = tcfg.DatasetConfig(cameras=cams)
    ds_j = jcfg.DatasetConfig(cameras=tuple(jcfg.CameraCalib(**dataclasses.asdict(c))
                                            for c in cams))
    rig_t = teuroc.rig_from_dataset(ds_t, "cpu")
    rig_j = jeuroc.rig_from_dataset(ds_j)
    assert type(rig_t.cam).__name__ == type(rig_j.cam).__name__
    for f in dataclasses.fields(rig_t.cam):
        a, b = getattr(rig_t.cam, f.name), getattr(rig_j.cam, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=RIG_TOL, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_allclose(rig_t.R_f_s.numpy(), np.asarray(rig_j.R_f_s), atol=RIG_TOL)
    np.testing.assert_allclose(rig_t.t_f_s.numpy(), np.asarray(rig_j.t_f_s), atol=RIG_TOL)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    world = jsyn.make_world(seed=6, n_frames=24, width=320, height=240, n_points=200)
    frames = [f._replace(images=np.clip(f.images, 0, 255).astype(np.uint8))
              for f in world.frames]
    root = str(tmp_path_factory.mktemp("seq"))
    teuroc.write_sequence(root, frames)
    return root, frames


def test_written_pngs_decode_to_the_frames(sequence):
    from PIL import Image

    root, frames = sequence
    d = os.path.join(root, "mav0", "cam1", "data")
    name = sorted(os.listdir(d))[5]
    png = os.path.join(d, name)
    np.testing.assert_array_equal(np.asarray(Image.open(png)), frames[5].images[1])
    np.testing.assert_array_equal(teuroc._load_image(png), frames[5].images[1].astype(np.float32))


def _compare_providers(pt, pj, level_tol):
    ft, fj = list(pt.frames()), list(pj.frames())
    assert len(ft) == len(fj) == 24
    for a, b in zip(ft, fj):
        assert a.ts == b.ts
        assert a.images.dtype == b.images.dtype == np.uint8
        diff = np.abs(a.images.astype(int) - b.images.astype(int))
        assert diff.max() <= level_tol
        for k in ("acc", "gyr", "dt"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    return ft


def test_provider_matches_jax(sequence):
    root, frames = sequence
    ft = _compare_providers(teuroc.EurocProvider(root), jeuroc.EurocProvider(root), 0)
    for a, f in zip(ft, frames):
        np.testing.assert_array_equal(a.images, f.images)
    # a provider with nothing to do on a device never asks for one
    assert teuroc.EurocProvider(root).device is None
    assert [len(f.dt) for f in ft[1:]] == [len(f.dt) for f in frames[1:]]


@pytest.mark.parametrize("contrast, distortion", [("clahe", (0.0,) * 4),
                                                  ("none", (-0.05, 0.01, 0.0, 0.0))])
def test_provider_with_clahe_or_undistortion_matches_jax(sequence, contrast, distortion):
    """Each on its own: CLAHE bins by intensity // 4, so a 1e-6 difference of
    the remapped value at a bin edge moves a pixel to the next bin's curve;
    the two are compared one at a time."""
    root, _ = sequence
    cams = [dict(model="pinhole", intrinsics=(200.0, 200.0, 160.0, 120.0),
                 distortion=distortion, width=320, height=240,
                 T_f_s=tuple(np.eye(4).reshape(-1).tolist()))] * 2
    ds_t = tcfg.DatasetConfig(cameras=tuple(tcfg.CameraCalib(**c) for c in cams))
    ds_j = jcfg.DatasetConfig(cameras=tuple(jcfg.CameraCalib(**c) for c in cams))
    pt = teuroc.EurocProvider(root, dataset=ds_t, contrast=contrast, device="cpu")
    assert pt.device == torch.device("cpu")
    assert (pt.maps is not None) == (contrast == "none")
    _compare_providers(pt, jeuroc.EurocProvider(root, dataset=ds_j, contrast=contrast), 1)


def test_imu_and_cam_csv_stamps_are_bit_equal(sequence):
    root, _ = sequence
    mav = os.path.join(root, "mav0")
    for a, b in zip(teuroc.load_imu_csv(os.path.join(mav, "imu0", "data.csv")),
                    jeuroc.load_imu_csv(os.path.join(mav, "imu0", "data.csv"))):
        np.testing.assert_array_equal(a, b)
    ta, na = teuroc.load_cam_csv(os.path.join(mav, "cam0", "data.csv"))
    tb, nb = jeuroc.load_cam_csv(os.path.join(mav, "cam0", "data.csv"))
    np.testing.assert_array_equal(ta, tb)
    assert na == nb


def test_log_writers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    traj = [(1.0 + 0.05 * k, rng.standard_normal((3, 3)), rng.standard_normal(3))
            for k in range(4)]
    rows = [tuple(rng.standard_normal(13)) for _ in range(5)]
    for mod, d in ((teuroc, tmp_path / "t"), (jeuroc, tmp_path / "j")):
        os.makedirs(d)
        mod.write_results_csv(str(d / "results.csv"), traj)
        mod.write_vio_csv(str(d / "vio_poses.csv"), rows)
    for name in ("results.csv", "vio_poses.csv"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


def test_dataset_yaml_round_trips_the_rig(tmp_path):
    from sadvio_tpu_torch.pipeline import synthetic as tsyn

    rig = tsyn.make_rig(width=320, height=240, device="cpu")
    path = str(tmp_path / "dataset.yaml")
    teuroc.write_dataset_yaml(path, rig)
    back = teuroc.rig_from_dataset(tcfg.load_dataset_config(path), "cpu")
    for name in ("fx", "fy", "cx", "cy"):
        assert torch.equal(getattr(back.cam, name), getattr(rig.cam, name))
    assert torch.equal(back.t_f_s, rig.t_f_s) and torch.equal(back.R_f_s, rig.R_f_s)
    jrig = jeuroc.rig_from_dataset(jcfg.load_dataset_config(path))  # the JAX loader reads it
    np.testing.assert_array_equal(np.asarray(jrig.cam.fx), rig.cam.fx.numpy())
    np.testing.assert_array_equal(np.asarray(jrig.t_f_s), rig.t_f_s.numpy())
