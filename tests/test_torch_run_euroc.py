"""The port's entry point end to end: a EuRoC folder on disk -> the CLI ->
log_slam/, and the comparison protocol's dry run.

The sequence and configs are those of tests/test_run_euroc.py: the
synthetic world (seed 6, 24 frames, 320x240) as uint8 PNGs with nanosecond
stamps from 1 s, its IMU samples, the rig's dataset.yaml and the bimono
config.  The gates are that test's: at least three keyframes, a finite last
keyframe pose within 2 m of the origin (the world spans less than 1 m), and
for the protocol an ATE below 0.1 m over at least three ground-truth pairs.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu_torch import run_euroc
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import euroc, native_io

torch.set_num_threads(2)

CONFIG = """slam_mode: bimono
tracker: klt
pose_estimator: pnp
optimizer: Analytic
contrast_enhancer: none
marginalization: 1
sparsification: 1
mesh3d: 0
min_kf_number: 3
max_kf_number: 5
fixed_frame_number: 1
min_lmk_number: 25
min_movement_parallax: 0.02
max_movement_parallax: 1.0
"""


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    world = jsyn.make_world(seed=6, n_frames=24, width=320, height=240, n_points=200)
    frames = [f._replace(images=f.images.astype(np.uint8)) for f in world.frames]
    data = str(tmp_path_factory.mktemp("ds"))
    euroc.write_sequence(data, frames, t0=1.0)
    cfgd = tmp_path_factory.mktemp("cfg")
    (cfgd / "config.yaml").write_text(CONFIG)
    rig = from_numpy(jax.tree.map(np.asarray, world.rig), "cpu")
    euroc.write_dataset_yaml(str(cfgd / "dataset.yaml"), rig)
    return str(cfgd), data, world


def _rows(path):
    return [[float(x) for x in line.split(",")]
            for line in open(path).read().strip().splitlines()]


def test_run_euroc_cli(euroc_dir, tmp_path, monkeypatch, capsys):
    cfgd, data_dir, world = euroc_dir
    monkeypatch.chdir(tmp_path)
    assert run_euroc.main([cfgd, data_dir, "--device", "cpu", "--profile"]) == 0
    out = capsys.readouterr().out
    assert ("[native loader] 24 synced frames" in out) == (native_io.shared_lib() is not None)
    rows = _rows(tmp_path / "log_slam" / "results.csv")
    assert len(rows) >= 3 and all(len(r) == 13 for r in rows)
    last = np.asarray(rows[-1][1:]).reshape(3, 4)
    assert np.isfinite(last).all()
    assert np.linalg.norm(last[:, 3]) < 2.0  # the world spans < 1 m
    # keyframe stamps are the sequence's: 1 s + the world's frame times
    stamps = {round(1.0 + f.ts, 6) for f in world.frames}
    assert all(round(r[0], 6) in stamps for r in rows)
    assert len(_rows(tmp_path / "log_slam" / "vio_poses.csv")) == len(world.frames)
    assert "frame_total" in (tmp_path / "log_slam" / "slam_profiler.txt").read_text()


def test_entry_point_takes_the_python_loader_without_the_native_library(
        euroc_dir, monkeypatch, capsys):
    cfgd, data_dir, _ = euroc_dir
    monkeypatch.setattr(native_io, "shared_lib", lambda: None)
    cfg, dataset = run_euroc.load_configs(cfgd)
    provider, loader = run_euroc.open_provider(data_dir, dataset, cfg.contrast_enhancer, "cpu")
    assert loader == "python" and isinstance(provider, euroc.EurocProvider)
    assert "[python loader]" in capsys.readouterr().out
    assert sum(1 for _ in provider.frames(max_frames=5)) == 5


@pytest.mark.parametrize("mode, cls", [("bimono", "StereoSLAM"), ("bimonovio", "StereoSLAM"),
                                       ("mono", "MonoSLAM"), ("monovio", "MonoSLAM"),
                                       ("nofov", "NoFovSLAM")])
def test_build_slam_dispatches_on_the_mode(euroc_dir, mode, cls):
    import dataclasses

    cfgd, _, _ = euroc_dir
    cfg, dataset = run_euroc.load_configs(cfgd)
    rig = euroc.rig_from_dataset(dataset, "cpu")
    slam = run_euroc.build_slam(dataclasses.replace(cfg, slam_mode=mode), rig,
                                run_euroc.imu_params_of(dataset), "cpu")
    assert type(slam).__name__ == cls and slam.device == torch.device("cpu")
    assert slam.imu_params.acc_noise == dataset.imu.acc_noise


def test_compare_euroc_protocol(euroc_dir, tmp_path, monkeypatch):
    """The port's row of the one-command comparison, with ATE against a
    ground-truth csv fabricated from the synthetic truth in the estimator's
    gauge (the first body frame), at EuRoC nanosecond stamps."""
    from sadvio_tpu_torch.tools import compare_euroc

    cfgd, data_dir, world = euroc_dir
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the replay runs in a subprocess
    gt_dir = os.path.join(data_dir, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    R0, t0 = world.gt_R[0], world.gt_t[0]
    rows = ["#ts,px,py,pz,qw,qx,qy,qz"]
    for i, f in enumerate(world.frames):
        p = R0.T @ (world.gt_t[i] - t0)
        rows.append(f"{int((1.0 + f.ts) * 1e9)},{p[0]},{p[1]},{p[2]},1,0,0,0")
    with open(os.path.join(gt_dir, "data.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    out = tmp_path / "cmp"
    assert compare_euroc.main(["--dataset", data_dir, "--config", cfgd, "--out", str(out),
                               "--device", "cpu"]) == 0
    table = json.loads((out / "comparison.json").read_text())
    assert [r["system"] for r in table] == ["sadvio_tpu_torch"]  # no --ref-bin: no reference row
    row = table[0]
    assert row["frames"] >= 20 and row["fps"] > 0
    assert row["ate_m"] is not None and row["ate_m"] < 0.1
    assert row["gt_pairs"] >= 3
