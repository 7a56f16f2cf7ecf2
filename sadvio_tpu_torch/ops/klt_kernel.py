"""Lucas-Kanade tracking kernels: the CUDA kernels and their plain PyTorch
versions.

``lk_iterate`` is the port of the TPU kernel ``sadvio_tpu/ops/klt_kernel.py``
(``_lk_kernel``): the inverse-compositional iteration loop on one pyramid
level.  ``lk_track`` is that kernel redesigned for the card: the whole
pyramidal forward-backward track of ``frontend/klt.py::track`` (templates,
every level's loop, backward pass, gates) in one launch.  On a CUDA tensor
each launches its hand-written kernel (``csrc/lk_iterate.cu``,
``csrc/lk_track.cu``, built with nvcc for sm_90a into one shared library
with a C interface at first use, loaded with ctypes); on a CPU tensor it
runs its plain version (``lk_iterate_ref``: the per-feature loop as masked
lock-step tensor ops; ``lk_track_ref``: templates and gates as tensor ops
around ``lk_iterate_ref``).  Nothing falls back: a build or launch failure
raises.

A launch recorded into a CUDA graph (the pipeline's captured stages,
``utils/graphs.py``) runs at each replay, and is counted there: the
capture's count is taken back and every replay adds it.

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

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("lk_iterate.cu", "lk_track.cu")
_HEADERS = ("lk_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
MAX_S = 15  # the kernels keep ceil(S^2 / 32) pixels per lane in registers
MAX_LEVELS = 8  # pyramid levels whose pointers fit the fused kernel's parameters
WINDOW_MARGIN = 4  # pixels around the patch in the fused kernel's shared-memory window
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the LK kernels cannot be built")
    return found


def build(clocks: bool = False) -> dict:
    """Compile csrc/*.cu into one library in BUILD_DIR unless a library built
    from the same source bytes is there; returns {"path", "seconds", "log"}.

    One nvcc per source, all started together, then one link.  The file
    name carries a hash of the sources and flags, so a stale library is
    never loaded.  ``clocks`` builds the variant that counts cycles per
    phase inside ``lk_track`` (``lk_track_clocks``)."""
    flags = NVCC_FLAGS + (("-DLK_CLOCKS",) if clocks else ())
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    lib = BUILD_DIR / f"liblk_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return {"path": lib, "seconds": 0.0, "log": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *flags, "-c", "-o", str(obj), str(_CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        for name, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return {"path": lib, "seconds": time.perf_counter() - t0, "log": "".join(logs).strip()}


@functools.lru_cache(maxsize=None)
def _library(clocks: bool = False):
    lib = ctypes.CDLL(str(build(clocks)["path"]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_iterate_launch.argtypes = [ptr] * 7 + [i32] * 5 + [f32, ptr]
    lib.lk_iterate_launch.restype = i32
    lib.lk_track_launch.argtypes = [ptr] * 11 + [i32] * 7 + [f32] * 4 + [ptr]
    lib.lk_track_launch.restype = i32
    if clocks:
        lib.lk_track_clocks.argtypes = [ptr, i32]
        lib.lk_track_clocks.restype = i32
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


# ----------------------------------------------------------------------
# the whole pyramidal track: lk_track (one launch) and its plain version
# ----------------------------------------------------------------------


def pyramid_dims(shape0, levels: int):
    """(H, W) of each pyramid level given the level-0 shape."""
    dims = [tuple(shape0)]
    for _ in range(levels - 1):
        h, w = dims[-1]
        dims.append(((h - h % 2) // 2, (w - w % 2) // 2))
    return dims


def _template_ws(radius: int, H: int, W: int) -> int:
    """Template window side, sized for a scale <= 2 warped halo patch."""
    rh = radius + 1
    return min(2 * (2 * rh + 2) + 2, H, W)


def template_windows(img0, uv0, radius: int):
    """Per-feature (WS, WS) windows of img0 around uv0 and their corners.

    The keyframe-rate half of template building (uv0 and img0 are constant
    between keyframes).  Returns (wins (N,WS,WS), base (N,2))."""
    H, W = img0.shape
    WS = _template_ws(radius, H, W)
    ctr = torch.floor(torch.nan_to_num(uv0, nan=0.0, posinf=0.0, neginf=0.0))
    base = torch.clamp(ctr - (WS // 2), min=0.0)
    base = torch.stack([torch.clamp(base[:, 0], max=W - WS), torch.clamp(base[:, 1], max=H - WS)],
                       -1)
    bi = base.long()
    r = torch.arange(WS, device=img0.device)
    rows = (bi[:, 1:2] + r)[:, :, None]
    cols = (bi[:, 0:1] + r)[:, None, :]
    return img0.reshape(-1)[rows * W + cols], base


def templates(img0, uv0, warp, radius: int, min_eig: float, tmpl_win=None):
    """Warped template patch, central-difference gradients, 2x2 normal matrix.

    One bilinear sample of an (S+2)^2 halo patch per feature from its
    window (coordinates clamped inside the window, as in the JAX package).
    Returns T/gx/gy (N,S,S), nrm (N,4) = [a,b,c,inv_det], good_grad (N,)."""
    S = 2 * radius + 1
    rh = radius + 1
    Sh = S + 2
    H, W = img0.shape
    WS = _template_ws(radius, H, W)
    r = torch.arange(-rh, rh + 1, dtype=uv0.dtype, device=uv0.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs2 = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)  # ((S+2)^2,2)
    pts = uv0[:, None, :] + torch.einsum("sj,nij->nsi", offs2, warp)
    wins, base = template_windows(img0, uv0, radius) if tmpl_win is None else tmpl_win

    loc = pts - base[:, None, :]
    flx, fly = torch.floor(loc[..., 0]), torch.floor(loc[..., 1])
    fx, fy = loc[..., 0] - flx, loc[..., 1] - fly
    ix = torch.nan_to_num(torch.clamp(flx, 0, WS - 2), nan=0.0).long()
    iy = torch.nan_to_num(torch.clamp(fly, 0, WS - 2), nan=0.0).long()
    flat = wins.reshape(wins.shape[0], -1)
    at = lambda yy, xx: torch.gather(flat, 1, yy * WS + xx)
    P = (at(iy, ix) * (1 - fx) * (1 - fy) + at(iy, ix + 1) * fx * (1 - fy)
         + at(iy + 1, ix) * (1 - fx) * fy + at(iy + 1, ix + 1) * fx * fy)
    P = P.reshape(-1, Sh, Sh)

    T = P[:, 1:-1, 1:-1]
    gx = 0.5 * (P[:, 1:-1, 2:] - P[:, 1:-1, :-2])
    gy = 0.5 * (P[:, 2:, 1:-1] - P[:, :-2, 1:-1])
    a = (gx * gx).sum((1, 2))
    b = (gx * gy).sum((1, 2))
    c = (gy * gy).sum((1, 2))
    det = a * c - b * b
    tr = a + c
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    good_grad = eig_min / (S * S) > min_eig
    inv_det = torch.where(torch.abs(det) < 1e-9, torch.zeros_like(det), 1.0 / det)
    nrm = torch.stack([a, b, c, inv_det], -1)
    return T.contiguous(), gx.contiguous(), gy.contiguous(), nrm, good_grad


def track_levels(pyr0, pyr1, uv0, uv_init, valid0, warp=None, *, levels: int = 3,
                 radius: int = 7, iters: int = 10, iters_coarse: int = 6, min_eig: float = 1e-3,
                 fb_thresh: float = 0.5, max_err: float = 20.0, bwd_levels: int = 1,
                 eps: float = 0.01, tmpl_wins=None, iterate=None):
    """The track level by level: per level, templates as tensor ops and one
    call of ``iterate`` (``lk_iterate``, or ``lk_iterate_ref`` for the plain
    version); forward over all levels, backward on ``bwd_levels`` from the
    answer, then the forward-backward and residual gates.

    ``warp`` (N,2,2) or None maps target-patch offsets to template-patch
    offsets; a warp that is not finite or whose determinant is outside
    (0.25, 4) counts as the identity.  ``tmpl_wins``: optional cache from
    ``template_windows_pyr(pyr0, uv0, ...)`` for the forward pass."""
    iterate = lk_iterate if iterate is None else iterate
    N = uv0.shape[0]
    eye = torch.eye(2, dtype=uv0.dtype, device=uv0.device).expand(N, 2, 2)
    if warp is None:
        warp = eye
    det = warp[:, 0, 0] * warp[:, 1, 1] - warp[:, 0, 1] * warp[:, 1, 0]
    good_w = (det > 0.25) & (det < 4.0) & torch.isfinite(warp).all(2).all(1)
    warp = torch.where(good_w[:, None, None], warp, eye)
    inv = torch.stack([
        torch.stack([warp[:, 1, 1], -warp[:, 0, 1]], -1),
        torch.stack([-warp[:, 1, 0], warp[:, 0, 0]], -1),
    ], -2) / torch.where(good_w, det, torch.ones_like(det))[:, None, None]

    def run(pa, pb, uv_a, uv_b0, A, use_levels, wins_pyr=None, is_bwd=False):
        uv = uv_b0 / (2 ** (use_levels - 1))
        ok = torch.ones(N, dtype=torch.bool, device=uv0.device)
        err = torch.zeros(N, dtype=uv0.dtype, device=uv0.device)
        for lvl in range(use_levels - 1, -1, -1):
            T, gx, gy, nrm, good_grad = templates(
                pa[lvl], uv_a / 2.0 ** lvl, A, radius, min_eig,
                tmpl_win=None if wins_pyr is None else wins_pyr[lvl])
            H, W = pb[lvl].shape
            out = iterate(pb[lvl].contiguous(), uv.contiguous(), T, gx, gy, nrm,
                          iters=iters if (lvl == 0 and not is_bwd) else iters_coarse, eps=eps)
            uv, err = out[:, :2], out[:, 2]
            inb = ((uv[:, 0] >= radius) & (uv[:, 0] < W - radius)
                   & (uv[:, 1] >= radius) & (uv[:, 1] < H - radius))
            ok = ok & good_grad & inb
            if lvl > 0:
                uv = uv * 2.0
        return uv, ok, err

    uv1, ok_f, err = run(pyr0, pyr1, uv0, uv_init, warp, levels, wins_pyr=tmpl_wins)
    uv0_back, ok_b, _ = run(pyr1, pyr0, uv1, uv0, inv, bwd_levels, is_bwd=True)
    fb = torch.linalg.norm(uv0_back - uv0, dim=-1)
    valid = valid0 & ok_f & ok_b & (fb < fb_thresh) & (err < max_err)
    return uv1, valid, err


def lk_track_ref(pyr0, pyr1, uv0, uv_init, valid0, warp=None, *, tmpl_wins=None, **kw):
    """Plain PyTorch version of ``lk_track``: ``track_levels`` around
    ``lk_iterate_ref``."""
    return track_levels(pyr0, pyr1, uv0, uv_init, valid0, warp, tmpl_wins=tmpl_wins,
                        iterate=lk_iterate_ref, **kw)


def _check_track(pyr0, pyr1, uv0, uv_init, valid0, warp, levels, radius, bwd_levels,
                 iters, iters_coarse):
    S = 2 * radius + 1
    if radius < 0 or S > MAX_S:
        raise ValueError(f"lk_track: patch side S={S} must be odd and <= {MAX_S}")
    if not 1 <= levels <= MAX_LEVELS or not 1 <= bwd_levels <= levels:
        raise ValueError(f"lk_track: 1 <= bwd_levels <= levels <= {MAX_LEVELS} expected")
    if iters < 0 or iters_coarse < 0:
        raise ValueError("lk_track: iteration counts must be >= 0")
    if len(pyr0) < levels or len(pyr1) < levels:
        raise ValueError(f"lk_track: pyramids of at least {levels} levels expected")
    imgs = (*pyr0[:levels], *pyr1[:levels])
    floats = (*imgs, uv0, uv_init) + (() if warp is None else (warp,))
    ts = (*floats, valid0)
    if any(not isinstance(x, torch.Tensor) for x in ts):
        raise TypeError("lk_track takes tensors")
    if any(x.dtype != torch.float32 for x in floats) or valid0.dtype != torch.bool:
        raise TypeError("lk_track takes float32 tensors and a bool valid0")
    if any(x.device != uv0.device for x in ts):
        raise ValueError("lk_track: all tensors must be on one device")
    if any(not x.is_contiguous() for x in ts):
        raise ValueError("lk_track: tensors must be contiguous")
    if pyr0[0].ndim != 2 or min(pyr0[0].shape) < 2 ** levels:
        raise ValueError(f"lk_track: level 0 {tuple(pyr0[0].shape)} too small for {levels} levels")
    dims = pyramid_dims(pyr0[0].shape, levels)
    if any(tuple(p.shape) != d for pyr in (pyr0, pyr1) for p, d in zip(pyr, dims)):
        raise ValueError(f"lk_track: level shapes must be {dims} in both pyramids")
    N = uv0.shape[0]
    if (tuple(uv0.shape) != (N, 2) or tuple(uv_init.shape) != (N, 2)
            or tuple(valid0.shape) != (N,)
            or (warp is not None and tuple(warp.shape) != (N, 2, 2))):
        raise ValueError("lk_track: uv0/uv_init (N,2), valid0 (N,), warp (N,2,2) expected")


def _launch_track(lib, pyr0, pyr1, uv0, uv_init, valid0, warp, margin, *, levels, radius, iters,
                  iters_coarse, min_eig, fb_thresh, max_err, bwd_levels, eps):
    """Allocate the outputs and launch lk_track_kernel of `lib` on the
    current stream."""
    dev, N = uv0.device, uv0.shape[0]
    uv1 = torch.empty((N, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((N,), dtype=torch.bool, device=dev)
    err = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return uv1, valid, err
    ptrs = lambda pyr: (ctypes.c_void_p * levels)(*[p.data_ptr() for p in pyr[:levels]])
    dims = pyramid_dims(pyr0[0].shape, levels)
    Hs = (ctypes.c_int * levels)(*[d[0] for d in dims])
    Ws = (ctypes.c_int * levels)(*[d[1] for d in dims])
    with torch.cuda.device(dev):
        rc = lib.lk_track_launch(
            ptrs(pyr0), ptrs(pyr1), Hs, Ws, uv0.data_ptr(), uv_init.data_ptr(),
            valid0.data_ptr(), None if warp is None else warp.data_ptr(), uv1.data_ptr(),
            valid.data_ptr(), err.data_ptr(), N, 2 * radius + 1, levels, bwd_levels, iters,
            iters_coarse, margin, min_eig, fb_thresh, max_err, eps * eps,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lk_track kernel launch failed: CUDA error {rc}")
    return uv1, valid, err


def lk_track(pyr0, pyr1, uv0, uv_init, valid0, warp=None, *, levels: int = 3, radius: int = 7,
             iters: int = 10, iters_coarse: int = 6, min_eig: float = 1e-3,
             fb_thresh: float = 0.5, max_err: float = 20.0, bwd_levels: int = 1,
             eps: float = 0.01, margin: int = WINDOW_MARGIN):
    """Pyramidal forward-backward LK track of all features in one launch.

    pyr0/pyr1: sequences of (H_l, W_l) levels as ``pyramid_dims`` gives
    them; uv0, uv_init (N,2); valid0 (N,) bool; warp (N,2,2) or None.
    Returns (uv1 (N,2), valid (N,) bool, err (N,)).  ``margin`` sizes the
    kernel's shared-memory window and does not change the result.  Counts
    kernel launches in ``lk_track.launches``, and per ``levels`` in
    ``lk_track.launches_by_levels``."""
    _check_track(pyr0, pyr1, uv0, uv_init, valid0, warp, levels, radius, bwd_levels,
                 iters, iters_coarse)
    kw = dict(levels=levels, radius=radius, iters=iters, iters_coarse=iters_coarse,
              min_eig=min_eig, fb_thresh=fb_thresh, max_err=max_err, bwd_levels=bwd_levels,
              eps=eps)
    if uv0.device.type == "cpu":
        return lk_track_ref(pyr0, pyr1, uv0, uv_init, valid0, warp, **kw)
    if uv0.device.type != "cuda":
        raise ValueError(f"lk_track: unsupported device {uv0.device}")
    out = _launch_track(_library(), pyr0, pyr1, uv0, uv_init, valid0, warp, margin, **kw)
    if uv0.shape[0] > 0:  # nothing was launched for no features, nothing to count
        lk_track.launches += 1
        lk_track.launches_by_levels[levels] = lk_track.launches_by_levels.get(levels, 0) + 1
    return out


lk_track.launches = 0
lk_track.launches_by_levels = {}

CLOCK_FIELDS = ("template_cycles", "window_load_cycles", "loop_cycles", "kernel_cycles",
                "window_loads", "iterations")


def _track_defaults(*, levels=3, radius=7, iters=10, iters_coarse=6, min_eig=1e-3,
                    fb_thresh=0.5, max_err=20.0, bwd_levels=1, eps=0.01):
    """The track's keywords with ``lk_track``'s defaults filled in."""
    return dict(locals())


def lk_track_clocks(pyr0, pyr1, uv0, uv_init, valid0, warp=None, *, margin: int = WINDOW_MARGIN,
                    **kw):
    """Where ``lk_track`` spends its cycles: launches the kernel of a library
    built with in-kernel counters (the card's machine has no kernel
    profiler) on CUDA tensors and returns an (N, 6) int64 CPU tensor, per
    feature ``CLOCK_FIELDS``: SM cycles in template building, in window
    loads, in the level loops without their loads and in the whole kernel,
    then the window loads and the iterations done.  Not counted as a
    launch of ``lk_track``."""
    kw = _track_defaults(**kw)
    _check_track(pyr0, pyr1, uv0, uv_init, valid0, warp, kw["levels"], kw["radius"],
                 kw["bwd_levels"], kw["iters"], kw["iters_coarse"])
    if uv0.device.type != "cuda":
        raise ValueError("lk_track_clocks runs on CUDA tensors only")
    lib = _library(True)
    _launch_track(lib, pyr0, pyr1, uv0, uv_init, valid0, warp, margin, **kw)
    N = uv0.shape[0]
    buf = (ctypes.c_longlong * (N * len(CLOCK_FIELDS)))()
    rc = lib.lk_track_clocks(buf, N)
    if rc != 0:
        raise RuntimeError(f"lk_track_clocks failed: CUDA error {rc}")
    return torch.tensor(list(buf), dtype=torch.int64).reshape(N, len(CLOCK_FIELDS))
