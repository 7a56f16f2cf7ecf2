"""The port's online provider, visualization hub, ROS payload decoding and
offline renders.

The provider cases are tests/test_online.py's, and every case also feeds
the same pushes to the JAX package's provider: the frames must be equal
(stamps, images and IMU batches exactly; both are numpy).  The renders are
tests/test_visualize.py's, on the port's run of that file's world (seed 2,
16 frames, 320x240, mesh3d) on the CPU: PNGs of real content (> 5 kB).
"""

import io
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from sadvio_tpu.pipeline import online as jonline
from sadvio_tpu_torch.pipeline import online as tonline

torch.set_num_threads(2)


def _img(v):
    return np.full((4, 6), float(v), np.float32)


def _both(n_cams=2):
    return tonline.OnlineProvider(n_cams=n_cams), jonline.OnlineProvider(n_cams=n_cams)


def _same(ft, fj):
    assert (ft is None) == (fj is None)
    if ft is None:
        return
    assert ft.ts == fj.ts
    for k in ("images", "acc", "gyr", "dt"):
        a, b = getattr(ft, k), getattr(fj, k)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_stereo_sync_and_imu_batching():
    providers = _both()
    for p in providers:
        for i in range(30):  # IMU at 100 Hz from t=0
            p.push_imu(0.01 * i, [0, 0, 9.81], [0, 0, 0])
        p.push_image(0, 0.050, _img(1))  # frame 0, partner within 2 ms
        p.push_image(1, 0.051, _img(2))
        p.push_image(0, 0.150, _img(3))  # frame 1
        p.push_image(1, 0.150, _img(4))
    f0 = [p.next(timeout=1.0) for p in providers]
    f1 = [p.next(timeout=1.0) for p in providers]
    _same(*f0)
    _same(*f1)
    assert f0[0].ts == 0.050 and f0[0].images.shape == (2, 4, 6)
    assert f0[0].acc.shape[0] == 0  # the first frame has no preceding batch
    assert f1[0].ts == 0.150
    assert f1[0].acc.shape[0] == 10  # IMU in (0.05, 0.15]: samples 0.06 ... 0.15
    np.testing.assert_allclose(f1[0].dt.sum(), 0.10, atol=1e-6)


def test_unpaired_frame_dropped():
    providers = _both()
    for p in providers:
        p.push_imu(0.0, [0, 0, 0], [0, 0, 0])
        p.push_image(0, 0.050, _img(1))  # its partner never arrives
        p.push_image(1, 0.120, _img(2))  # the next stereo pair
        p.push_image(0, 0.121, _img(3))
        p.push_imu(0.2, [0, 0, 0], [0, 0, 0])
    f = [p.next(timeout=1.0) for p in providers]
    _same(*f)
    assert abs(f[0].ts - 0.121) < 1e-9


def test_back_pressure_drops_the_oldest_frame():
    providers = [tonline.OnlineProvider(n_cams=1, max_queue=2),
                 jonline.OnlineProvider(n_cams=1, max_queue=2)]
    for p in providers:
        for k in range(5):
            p.push_imu(0.1 * k, [0, 0, 9.81], [0, 0, 0])
            p.push_image(0, 0.1 * k, _img(k))
        p.close()
    got = [list(p) for p in providers]
    assert [f.ts for f in got[0]] == [f.ts for f in got[1]] == [0.1 * 3, 0.1 * 4]
    for a, b in zip(*got):
        _same(a, b)


def test_close_unblocks_consumer():
    p = tonline.OnlineProvider(n_cams=1)
    got = []
    t = threading.Thread(target=lambda: got.append(p.next(timeout=5.0)))
    t.start()
    p.close()
    t.join(2.0)
    assert not t.is_alive() and got == [None]


def test_visualizer_hub_fanout():
    hub = tonline.VisualizerHub()
    seen = []
    hub.subscribe("pose", lambda pl: seen.append(("pose", pl["t"][0])))
    hub.subscribe("trajectory", lambda pl: seen.append(("traj", len(pl))))
    hub.publish_keyframe(R=np.eye(3), t=np.asarray([1.0, 0, 0]), traj=np.zeros((5, 3)))
    assert ("pose", 1.0) in seen and ("traj", 5) in seen
    assert tonline.VisualizerHub.TOPICS == jonline.VisualizerHub.TOPICS
    with pytest.raises(KeyError):
        hub.subscribe("nope", print)


def test_decode_compressed_png_jpeg():
    from sadvio_tpu.ros2_node import decode_compressed as jdecode
    from sadvio_tpu_torch.ros2_node import decode_compressed

    rng = np.random.default_rng(0)
    gray = rng.integers(0, 255, (32, 48), np.uint8)
    rgb = rng.integers(0, 255, (8, 8, 3), np.uint8)
    for arr, fmt in ((gray, "PNG"), (gray, "JPEG"), (rgb, "PNG")):
        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format=fmt, **({"quality": 92} if fmt == "JPEG" else {}))
        out = decode_compressed(buf.getvalue())
        assert out.dtype == np.float32 and out.shape == arr.shape[:2]
        np.testing.assert_array_equal(out, jdecode(buf.getvalue()))
        if fmt == "PNG" and arr.ndim == 2:
            np.testing.assert_array_equal(out, gray.astype(np.float32))  # lossless
        elif arr.ndim == 2:
            assert np.abs(out - gray).mean() < 4.0
        else:
            np.testing.assert_allclose(out, rgb.astype(np.float32).mean(-1))


@pytest.fixture(scope="module")
def run():
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    world = synthetic.make_world(seed=2, n_frames=16, width=320, height=240, n_points=200,
                                 imu_noise=False, device="cpu")
    cfg = SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                     max_movement_parallax=1.0, min_movement_parallax=0.02, mesh3d=True,
                     max_length_tsh=2.0, zncc_tsh=0.5,
                     caps=Capacities(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))
    slam = StereoSLAM(world.rig, cfg, device="cpu")
    slam.run(world.frames)
    return world, slam


def test_snapshot_overlays(run, tmp_path):
    from sadvio_tpu_torch.tools import visualize

    world, slam = run
    files = visualize.snapshot(slam, world.frames[-1], str(tmp_path / "snap"))
    assert any(f.endswith("_features.png") for f in files)
    assert any(f.endswith("_mesh.png") for f in files)
    for f in files:
        assert os.path.getsize(f) > 5000  # a real render, not an empty figure


def test_plot_run_and_results_csv(run, tmp_path):
    from sadvio_tpu_torch.tools import visualize

    world, slam = run
    assert os.path.getsize(visualize.plot_run(slam, str(tmp_path / "traj.png"),
                                              world=world)) > 5000
    slam.write_logs(str(tmp_path / "log"))
    assert visualize.main([str(tmp_path / "log" / "results.csv"), str(tmp_path / "kf.png")]) == 0
    assert os.path.getsize(tmp_path / "kf.png") > 5000
