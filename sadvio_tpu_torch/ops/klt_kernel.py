"""Inverse-compositional LK iteration loop: the CUDA kernel and its plain
PyTorch version.

``lk_iterate`` is the port of the TPU kernel ``sadvio_tpu/ops/klt_kernel.py``
(``_lk_kernel``).  On a CUDA tensor it launches the hand-written kernel in
``csrc/lk_iterate.cu`` (built with nvcc for sm_90a into a shared library
with a C interface at first use, loaded with ctypes); on a CPU tensor it
runs ``lk_iterate_ref``, the same per-feature loop as masked lock-step
tensor ops.  Nothing falls back: a build or launch failure raises.

Semantics (both versions): the patch corner is floor((u, v) - half) and
every pixel of the patch shares the fractional offset; bilinear taps read
the image at edge-clamped integer coordinates; a feature stops at `iters`
or once its step is at most `eps` pixels, and a NaN step stops it at once.
Returns (N, 3): refined u, v and the mean |patch - T| at that position.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "lk_iterate.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
MAX_S = 15  # the kernel keeps ceil(S^2 / 32) pixels per lane in registers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the LK kernel cannot be built")
    return found


def build() -> dict:
    """Compile csrc/lk_iterate.cu into BUILD_DIR unless a library built from
    the same source bytes is there; returns {"path", "seconds", "log"}.

    The file name carries a hash of the source, so a stale library is never
    loaded."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"liblk_iterate_{digest}.so"
    if lib.exists():
        return {"path": lib, "seconds": 0.0, "log": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": lib, "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip()}


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()["path"]))
    fn = lib.lk_iterate_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(img1, uv_init, T, gx, gy, nrm, iters):
    ts = (img1, uv_init, T, gx, gy, nrm)
    if any(not isinstance(x, torch.Tensor) for x in ts):
        raise TypeError("lk_iterate takes tensors")
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError("lk_iterate takes float32 tensors")
    if any(x.device != img1.device for x in ts):
        raise ValueError("lk_iterate: all tensors must be on one device")
    if img1.ndim != 2 or T.ndim != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"lk_iterate: bad shapes img1 {tuple(img1.shape)} T {tuple(T.shape)}")
    N, S = T.shape[0], T.shape[1]
    if S % 2 != 1 or S > MAX_S:
        raise ValueError(f"lk_iterate: patch side S={S} must be odd and <= {MAX_S}")
    if (tuple(uv_init.shape) != (N, 2) or tuple(gx.shape) != (N, S, S)
            or tuple(gy.shape) != (N, S, S) or tuple(nrm.shape) != (N, 4)):
        raise ValueError("lk_iterate: uv_init (N,2), gx/gy (N,S,S), nrm (N,4) expected")
    if iters < 0:
        raise ValueError("lk_iterate: iters must be >= 0")


def lk_iterate(img1, uv_init, T, gx, gy, nrm, *, iters: int = 10, eps: float = 0.01):
    """IC-LK iterations for all features on one level.

    img1 (H,W); uv_init (N,2); T/gx/gy (N,S,S) template patch and its
    gradients; nrm (N,4) = [a, b, c, inv_det] of the 2x2 normal matrix.
    Returns (N,3) [u, v, err].  Counts kernel launches in
    ``lk_iterate.launches``."""
    _check(img1, uv_init, T, gx, gy, nrm, iters)
    if img1.device.type == "cpu":
        return lk_iterate_ref(img1, uv_init, T, gx, gy, nrm, iters=iters, eps=eps)
    if img1.device.type != "cuda":
        raise ValueError(f"lk_iterate: unsupported device {img1.device}")
    for x in (img1, uv_init, T, gx, gy, nrm):
        if not x.is_contiguous():
            raise ValueError("lk_iterate: CUDA tensors must be contiguous")
    N, S = T.shape[0], T.shape[1]
    H, W = img1.shape
    out = torch.empty((N, 3), dtype=torch.float32, device=img1.device)
    if N == 0:  # nothing to launch, nothing to count
        return out
    with torch.cuda.device(img1.device):
        stream = torch.cuda.current_stream(img1.device).cuda_stream
        err = _library().lk_iterate_launch(
            img1.data_ptr(), uv_init.data_ptr(), T.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), nrm.data_ptr(), out.data_ptr(), N, S, H, W, iters,
            ctypes.c_float(eps * eps), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"lk_iterate kernel launch failed: CUDA error {err}")
    lk_iterate.launches += 1
    return out


lk_iterate.launches = 0


def _patches(img1, u, v, S):
    """(N,S,S) bilinear patches centred at (u, v), taps edge-clamped."""
    H, W = img1.shape
    half = (S - 1) // 2
    r = torch.arange(S, device=img1.device)
    lx, ly = u - half, v - half
    flx, fly = torch.floor(lx), torch.floor(ly)
    fx, fy = (lx - flx)[:, None, None], (ly - fly)[:, None, None]
    ix = torch.nan_to_num(torch.clamp(flx, -1.0, float(W)), nan=0.0).long()
    iy = torch.nan_to_num(torch.clamp(fly, -1.0, float(H)), nan=0.0).long()
    c0 = torch.clamp(ix[:, None] + r, 0, W - 1)[:, None, :]
    c1 = torch.clamp(ix[:, None] + r + 1, 0, W - 1)[:, None, :]
    r0 = torch.clamp(iy[:, None] + r, 0, H - 1)[:, :, None] * W
    r1 = torch.clamp(iy[:, None] + r + 1, 0, H - 1)[:, :, None] * W
    flat = img1.reshape(-1)
    return (flat[r0 + c0] * (1 - fx) * (1 - fy) + flat[r0 + c1] * fx * (1 - fy)
            + flat[r1 + c0] * (1 - fx) * fy + flat[r1 + c1] * fx * fy)


def lk_iterate_ref(img1, uv_init, T, gx, gy, nrm, *, iters: int = 10, eps: float = 0.01):
    """Plain PyTorch version of the kernel: all features advance in lock
    step and a feature that has stopped is frozen (masked update)."""
    S = T.shape[1]
    u, v = uv_init[:, 0], uv_init[:, 1]
    a, b, c, inv_det = nrm.unbind(1)
    active = torch.ones_like(u, dtype=torch.bool)
    eps2 = eps * eps
    for _ in range(iters):
        e = _patches(img1, u, v, S) - T
        bx = (e * gx).sum((1, 2))
        by = (e * gy).sum((1, 2))
        du = (c * bx - b * by) * inv_det
        dv = (a * by - b * bx) * inv_det
        u = torch.where(active, u - du, u)
        v = torch.where(active, v - dv, v)
        active = active & (du * du + dv * dv > eps2)
    err = (_patches(img1, u, v, S) - T).abs().mean((1, 2))
    return torch.stack([u, v, err], 1)
