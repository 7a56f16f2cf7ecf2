"""The port's native runtime bindings: its own build of native/, the Delaunay
triangulation against scipy and against the JAX package's binding, and the
native provider against the Python one.

The fabricated sequence is tests/test_native_io.py's (64x48 random frames
at 20 Hz, IMU at 200 Hz, made with numpy).

Tolerances: triangle sets equal to scipy's (points in general position
have one Delaunay triangulation), triangles and their order equal to the
JAX binding's (the same source); provider frames, stamps and IMU batches
bit-equal (the same decoded pixels go through the same preparation).
"""

import os
import threading

import numpy as np
import pytest
import torch

from sadvio_tpu_torch.pipeline import euroc as teuroc, native_io

torch.set_num_threads(2)

W, H, NF, IMU_HZ, FPS = 64, 48, 6, 200, 20


@pytest.fixture(scope="module")
def lib():
    lib = native_io.shared_lib()
    assert lib is not None, native_io.load_error()
    return lib


@pytest.fixture(scope="module")
def fake_euroc(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("euroc") / "mav0"
    rng = np.random.default_rng(0)
    for c in (0, 1):
        d = root / f"cam{c}" / "data"
        d.mkdir(parents=True)
        rows = ["#ts,filename"]
        for k in range(NF):
            ts_ns = int((1.0 + k / FPS) * 1e9)
            Image.fromarray(rng.integers(0, 255, (H, W), np.uint8), "L").save(d / f"{ts_ns}.png")
            rows.append(f"{ts_ns},{ts_ns}.png")
        (root / f"cam{c}" / "data.csv").write_text("\n".join(rows) + "\n")
    (root / "imu0").mkdir()
    rows = ["#ts,wx,wy,wz,ax,ay,az"]
    for k in range(int(NF / FPS * IMU_HZ) + IMU_HZ):
        v = rng.standard_normal(6) * 0.01
        v[5] = 9.81
        rows.append(",".join([str(int((0.5 + k / IMU_HZ) * 1e9))] + [f"{x:.6f}" for x in v]))
    (root / "imu0" / "data.csv").write_text("\n".join(rows) + "\n")
    return str(root.parent)


def test_library_is_built_into_the_port(lib):
    path = native_io.build()
    assert path.parent == native_io.BUILD_DIR and path.name.startswith("libsadvio_native_")
    assert native_io.build() == path  # cached by the sources' hash


def test_concurrent_builds_share_one_library(lib, tmp_path, monkeypatch):
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path)
    out, errs = [], []

    def one():
        try:
            out.append(native_io.build())
        except Exception as e:  # collected and asserted below
            errs.append(e)

    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(set(out)) == 1 and out[0].exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([out[0].name, "native.lock"])


def test_delaunay_matches_scipy_and_the_jax_binding(lib, rng):
    from scipy.spatial import Delaunay

    from sadvio_tpu.pipeline.native_io import native_delaunay as jax_delaunay

    pts = rng.uniform(0, 100, (60, 2)).astype(np.float32)
    tris = native_io.native_delaunay(pts)
    ref = Delaunay(pts.astype(np.float64)).simplices
    as_set = lambda t: {tuple(sorted(r)) for r in np.asarray(t).tolist()}
    assert len(tris) == len(ref) and as_set(tris) == as_set(ref)
    p = pts.astype(np.float64)
    a, b, c = p[tris[:, 0]], p[tris[:, 1]], p[tris[:, 2]]
    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    assert (area2 > 0).all()  # counter-clockwise
    j = jax_delaunay(pts)
    if j is not None:  # the JAX package's binding of the same source
        np.testing.assert_array_equal(tris, j)


def test_delaunay_degenerate_inputs(lib):
    line = np.stack([np.arange(5, dtype=np.float32)] * 2, -1)
    assert len(native_io.native_delaunay(line)) == 0
    assert len(native_io.native_delaunay(np.zeros((4, 2), np.float32))) == 0


def test_mesher_triangulates_natively_like_the_jax_package(lib, rng):
    from sadvio_tpu.mesh import mesh as jmesh
    from sadvio_tpu_torch.mesh import mesh as tmesh

    uv = rng.uniform(0, 300, (80, 2)).astype(np.float32)
    valid = rng.uniform(size=80) > 0.2
    tt, mt, n = tmesh.delaunay_triangles(uv, valid, 256)
    tj, mj = jmesh.delaunay_triangles(uv, valid, 256)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(tt, tj.astype(np.int64))
    assert n == mt.sum() > 0


@pytest.mark.parametrize("contrast", ["none", "clahe"])
def test_native_provider_matches_the_python_one(lib, fake_euroc, contrast):
    nat = native_io.NativeEurocProvider(fake_euroc, contrast=contrast, device="cpu")
    py = teuroc.EurocProvider(fake_euroc, contrast=contrast, device="cpu")
    assert nat.n_frames == NF
    fn, fp = list(nat.frames()), list(py.frames())
    assert len(fn) == len(fp) == NF
    for a, b in zip(fn, fp):
        assert a.ts == b.ts
        assert a.images.dtype == b.images.dtype == np.uint8
        np.testing.assert_array_equal(a.images, b.images)
        assert len(a.dt) == len(b.dt)
        np.testing.assert_allclose(a.dt, b.dt, atol=1e-6)
        np.testing.assert_allclose(a.acc, b.acc, atol=1e-5)
        np.testing.assert_allclose(a.gyr, b.gyr, atol=1e-5)
    for f in fp[1:]:
        assert 8 <= len(f.dt) <= 12  # 200 Hz / 20 Hz = 10 samples per interval
        np.testing.assert_allclose(f.dt.sum(), 1.0 / FPS, atol=1e-3)
    nat.close()


def test_native_provider_refuses_a_missing_directory(lib, tmp_path):
    with pytest.raises(FileNotFoundError):
        native_io.NativeEurocProvider(str(tmp_path / "none"))
    assert os.path.isdir(native_io.BUILD_DIR)
