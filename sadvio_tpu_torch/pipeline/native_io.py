"""ctypes bindings of the native C++ data-loading runtime.

Port of ``sadvio_tpu/pipeline/native_io.py``.  ``native/dataloader.cpp``
parses the EuRoC CSVs, syncs stereo and IMU, and decodes the PNGs on a
worker thread into a bounded ring ahead of the consumer;
``native/delaunay.cpp`` is a Bowyer-Watson 2D Delaunay triangulation.  The
port compiles both with g++ into its own ``sadvio_tpu_torch/build/`` (a
library named by a hash of the sources, built under a file lock, so
concurrent processes neither race nor touch ``native/``), and loads it
through a plain C ABI.

Without a compiler, zlib or the sources, ``shared_lib()`` is None: the
entry point then reads with the Python ``EurocProvider`` and the mesher
triangulates with scipy, as in the JAX package.

Unlike the JAX package's native provider, this one applies the config's
undistortion and contrast enhancement too (on ``device``), so a sequence
reads the same through either loader.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from sadvio_tpu_torch.pipeline.euroc import prepare_images, undistort_maps
from sadvio_tpu_torch.pipeline.synthetic import FrameData
from sadvio_tpu_torch.utils.struct import entry_device

_NATIVE = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("dataloader.cpp", "delaunay.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")


def build() -> Path:
    """Compile the native sources into BUILD_DIR unless a library built from
    the same bytes is there; returns its path.  Raises on a failed build."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_NATIVE / name).read_bytes())
    lib = BUILD_DIR / f"libsadvio_native_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():  # another process may have built it meanwhile
            tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(_NATIVE / s) for s in SOURCES),
                 "-lz", "-lpthread"], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, lib)
    return lib


def _load_lib():
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32_p = ctypes.c_void_p, ctypes.c_int, np.ctypeslib.ndpointer(
        np.float32, flags="C_CONTIGUOUS")
    lib.euroc_open.restype = ptr
    lib.euroc_open.argtypes = [ctypes.c_char_p]
    lib.euroc_n_frames.restype = i32
    lib.euroc_n_frames.argtypes = [ptr]
    lib.euroc_next_info.restype = i32
    lib.euroc_next_info.argtypes = [ptr] + [ctypes.POINTER(i32)] * 3
    lib.euroc_next_frame.restype = ctypes.c_double
    lib.euroc_next_frame.argtypes = [ptr, f32_p, f32_p,
                                     np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.euroc_close.restype = None
    lib.euroc_close.argtypes = [ptr]
    lib.sadvio_delaunay.restype = i32
    lib.sadvio_delaunay.argtypes = [f32_p, i32, np.ctypeslib.ndpointer(
        np.int32, flags="C_CONTIGUOUS"), i32]
    return lib


_LIB = None
_LIB_ERROR = None


def shared_lib():
    """The native library (built and loaded once per process), or None when
    it cannot be built; ``load_error()`` then says why."""
    global _LIB, _LIB_ERROR
    if _LIB is None and _LIB_ERROR is None:
        try:
            _LIB = _load_lib()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _LIB_ERROR = e
    return _LIB


def load_error():
    return _LIB_ERROR


def native_delaunay(pts: np.ndarray) -> Optional[np.ndarray]:
    """2D Delaunay triangulation of (n,2) points: (m,3) int32 indices into
    ``pts``, counter-clockwise, or None without the native library."""
    lib = shared_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(pts, np.float32)
    n = len(p)
    cap = max(4 * n, 16)
    out = np.empty((cap, 3), np.int32)
    m = lib.sadvio_delaunay(p, n, out.reshape(-1), cap)
    if m < 0:  # capacity overflow cannot happen at 4n for a planar set
        return None
    return out[:m].copy()


class NativeEurocProvider:
    """Synced stereo + IMU frames from the native prefetching loader, with
    the undistortion and contrast enhancement of ``EurocProvider`` run on
    ``device`` (None: the CUDA card; only touched when there is such work).
    Raises RuntimeError without the native library."""

    def __init__(self, root: str, dataset=None, contrast: str = "none", undistort: bool = True,
                 device=None):
        self.lib = shared_lib()
        if self.lib is None:
            raise RuntimeError(f"native loader unavailable: {load_error()}")
        self.handle = self.lib.euroc_open(root.encode())
        if not self.handle:
            raise FileNotFoundError(f"not an EuRoC directory: {root}")
        self.contrast = contrast
        maps = undistort_maps(dataset, "cpu") if undistort else None
        self.device = (entry_device(device)
                       if maps is not None or contrast not in (None, "", "none") else None)
        self.maps = None if maps is None else [m if m is None else m.to(self.device)
                                               for m in maps]

    @property
    def n_frames(self) -> int:
        return self.lib.euroc_n_frames(self.handle)

    def frames(self, max_frames: Optional[int] = None) -> Iterator[FrameData]:
        n = 0
        w, h, ni = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while self.handle:
            if not self.lib.euroc_next_info(self.handle, w, h, ni):
                return
            img0 = np.empty((h.value, w.value), np.float32)
            img1 = np.empty((h.value, w.value), np.float32)
            imu = np.empty((max(ni.value, 1), 7), np.float64)
            ts = self.lib.euroc_next_frame(self.handle, img0, img1, imu)
            if ts < 0:
                return
            m = imu[: ni.value]
            yield FrameData(ts=float(ts),
                            images=prepare_images([img0, img1], self.maps, self.contrast,
                                                  self.device),
                            gyr=m[:, 1:4].astype(np.float32), acc=m[:, 4:7].astype(np.float32),
                            dt=m[:, 0].astype(np.float32))
            n += 1
            if max_frames is not None and n >= max_frames:
                return

    def close(self):
        if self.handle:
            self.lib.euroc_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
