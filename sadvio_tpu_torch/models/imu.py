"""On-manifold IMU preintegration (Forster style) on tensors.

Port of ``sadvio_tpu/models/imu.py``.  The JAX package integrates with a
masked ``lax.scan``.  Here ``preintegrate`` runs the whole recursion of a
buffer in one launch of a hand-written kernel on a CUDA tensor
(``ops/csrc/imu_preint.cu``, built at first use with the LK kernels and
loaded with ctypes) and the plain version ``preintegrate_ref`` on a CPU
tensor: the per-sample terms that do not depend on the running state
(bias-corrected rates, the incremental rotations and their right Jacobians)
computed for the whole buffer at once, then a Python loop.  Samples with
dt <= 0 stay strict no-ops, as in the reference.

``chunk_summary`` / ``combine_summary`` / ``preintegrate_assoc`` are the
log-depth form of the same recursion: a chunk of samples reduces to a
``ChunkSummary`` by three associative scans, and summaries of adjacent
chunks compose, which is what shards the IMU stream along time
(``parallel/time_sharding.py``).  The pipeline integrates with the
sequential ``preintegrate``, as the JAX pipeline does.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from sadvio_tpu_torch.ops import klt_kernel
from sadvio_tpu_torch.utils import geometry as geo
from sadvio_tpu_torch.utils.struct import Struct, select, tree_map

GRAVITY = 9.81


@dataclass
class ImuParams(Struct):
    """Continuous-time noise densities (EuRoC yaml convention), as floats."""

    acc_noise: float
    gyr_noise: float
    acc_walk: float
    gyr_walk: float
    rate_hz: float = 200.0

    @classmethod
    def euroc(cls):
        return cls(acc_noise=2.0e-3, gyr_noise=1.7e-4, acc_walk=3.0e-3,
                   gyr_walk=2.0e-5, rate_hz=200.0)


@dataclass
class Preintegration(Struct):
    """Preintegrated deltas between two keyframes (optionally batched)."""

    dR: torch.Tensor  # (...,3,3)
    dv: torch.Tensor  # (...,3)
    dp: torch.Tensor  # (...,3)
    cov: torch.Tensor  # (...,9,9) over (dphi, dv, dp)
    J_dR_bg: torch.Tensor
    J_dv_ba: torch.Tensor
    J_dv_bg: torch.Tensor
    J_dp_ba: torch.Tensor
    J_dp_bg: torch.Tensor
    dt: torch.Tensor  # (...)
    ba_lin: torch.Tensor  # (...,3)
    bg_lin: torch.Tensor  # (...,3)

    @classmethod
    def identity(cls, dtype=torch.float32, device=None, batch=()):
        eye = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone()
        z3 = torch.zeros((*batch, 3, 3), dtype=dtype, device=device)
        z = lambda *s: torch.zeros((*batch, *s), dtype=dtype, device=device)
        return cls(dR=eye, dv=z(3), dp=z(3), cov=z(9, 9),
                   J_dR_bg=z3, J_dv_ba=z3.clone(), J_dv_bg=z3.clone(),
                   J_dp_ba=z3.clone(), J_dp_bg=z3.clone(),
                   dt=z(), ba_lin=z(3), bg_lin=z(3))

    def __getitem__(self, k):
        """Element k of a batched preintegration."""
        return tree_map(lambda x: x[k], self)


# The fields a preintegration carries through the recursion, with their
# shapes, in the order of the kernel's (142,) output buffer.
_STATE_SHAPES = {"dR": (3, 3), "dv": (3,), "dp": (3,), "cov": (9, 9), "J_dR_bg": (3, 3),
                 "J_dv_ba": (3, 3), "J_dv_bg": (3, 3), "J_dp_ba": (3, 3), "J_dp_bg": (3, 3),
                 "dt": ()}
_STATE_SIZES = [math.prod(s) for s in _STATE_SHAPES.values()]
_STATE_SIZE = sum(_STATE_SIZES)  # kState in ops/csrc/imu_preint.cu


def _check(acc, gyr, dt, ba, bg, init):
    """What the kernel takes, checked on every device, so that a CPU run
    meets a call that the card would refuse."""
    ts = {"acc": acc, "gyr": gyr, "dt": dt, "ba": ba, "bg": bg}
    if init is not None:
        ts.update({f"init.{f}": getattr(init, f) for f in _STATE_SHAPES})
    if any(not isinstance(x, torch.Tensor) for x in ts.values()):
        raise TypeError("preintegrate takes tensors")
    bad = [k for k, x in ts.items() if x.dtype != torch.float32]
    if bad:
        raise TypeError(f"preintegrate takes float32 tensors; not: {bad}")
    if any(x.device != acc.device for x in ts.values()):
        raise ValueError("preintegrate: all tensors must be on one device")
    n = acc.shape[0] if acc.ndim == 2 else -1
    want = {"acc": (n, 3), "gyr": (n, 3), "dt": (n,), "ba": (3,), "bg": (3,),
            **{f"init.{f}": s for f, s in _STATE_SHAPES.items()}}
    bad = [f"{k} {tuple(x.shape)}" for k, x in ts.items() if tuple(x.shape) != want[k]]
    if bad:
        raise ValueError(f"preintegrate: acc, gyr (N,3), dt (N,), ba, bg (3,) and the init "
                         f"fields' own shapes expected; got {bad}")
    if (acc.stride(1) != 1 or gyr.stride(1) != 1
            or not all(x.is_contiguous() for k, x in ts.items() if k not in ("acc", "gyr", "dt"))):
        raise ValueError("preintegrate: the rows of acc and gyr, ba, bg and the init fields "
                         "must be contiguous")


def preintegrate(acc, gyr, dt, ba, bg, params: ImuParams, init: Preintegration | None = None):
    """Integrate a buffer of IMU samples; padding samples must have dt == 0.

    acc, gyr: (N,3) float32 with contiguous rows; dt: (N,); ba, bg: (3,)
    bias linearization point; ``init``: the preintegration to continue.  On
    a CUDA tensor one launch of ``ops/csrc/imu_preint.cu`` on the current
    stream (no host synchronisation), counted in ``preintegrate.launches``;
    on a CPU tensor ``preintegrate_ref``.  Nothing falls back: a launch
    failure raises."""
    _check(acc, gyr, dt, ba, bg, init)
    dev = acc.device
    if dev.type == "cpu":
        return preintegrate_ref(acc, gyr, dt, ba, bg, params, init)
    if dev.type != "cuda":
        raise ValueError(f"preintegrate: unsupported device {dev}")
    if init is None:
        init = Preintegration.identity(acc.dtype, dev)
    out = torch.empty(_STATE_SIZE, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = klt_kernel._library().imu_preint_launch(
            acc.data_ptr(), gyr.data_ptr(), dt.data_ptr(), ba.data_ptr(), bg.data_ptr(),
            *[getattr(init, f).data_ptr() for f in _STATE_SHAPES], out.data_ptr(), acc.shape[0],
            acc.stride(0), gyr.stride(0), dt.stride(0),
            ctypes.c_float(params.gyr_noise ** 2), ctypes.c_float(params.acc_noise ** 2),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"preintegrate kernel launch failed: CUDA error {err}")
    preintegrate.launches += 1
    fields = {f: x.view(shape) for (f, shape), x in zip(_STATE_SHAPES.items(),
                                                         out.split(_STATE_SIZES))}
    return Preintegration(**fields, ba_lin=ba, bg_lin=bg)


preintegrate.launches = 0


def preintegrate_ref(acc, gyr, dt, ba, bg, params: ImuParams,
                     init: Preintegration | None = None):
    """Plain version of the kernel on any device: the per-sample terms for
    the whole buffer, then one Python loop step per sample."""
    dtype, dev = acc.dtype, acc.device
    if init is None:
        init = Preintegration.identity(dtype, dev)
    s = init.replace(ba_lin=ba, bg_lin=bg)
    active = dt > 0.0
    hs = torch.where(active, dt, torch.ones_like(dt))
    h_all = torch.where(active, dt, torch.zeros_like(dt))
    a_c_all = acc - ba
    wdt = (gyr - bg) * h_all[:, None]
    dR_inc_all = geo.so3_exp(wdt)
    Jr_all = geo.so3_right_jacobian(wdt)
    qg_all = params.gyr_noise ** 2 / hs
    qa_all = params.acc_noise ** 2 / hs
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    for i in range(acc.shape[0]):
        h = h_all[i]
        a_c = a_c_all[i]
        dR_inc, Jr = dR_inc_all[i], Jr_all[i]
        Ra = s.dR @ geo.skew(a_c)
        A = torch.cat([
            torch.cat([dR_inc.T, z3, z3], 1),
            torch.cat([-Ra * h, eye3, z3], 1),
            torch.cat([-0.5 * Ra * h * h, eye3 * h, eye3], 1),
        ], 0)
        B = torch.cat([
            torch.cat([Jr * h, z3], 1),
            torch.cat([z3, s.dR * h], 1),
            torch.cat([z3, 0.5 * s.dR * h * h], 1),
        ], 0)
        q = torch.cat([qg_all[i].expand(3), qa_all[i].expand(3)])
        cov = A @ s.cov @ A.T + (B * q) @ B.T
        new = s.replace(
            dR=s.dR @ dR_inc,
            dv=s.dv + geo.mv(s.dR, a_c) * h,
            dp=s.dp + s.dv * h + 0.5 * geo.mv(s.dR, a_c) * h * h,
            cov=cov,
            J_dR_bg=dR_inc.T @ s.J_dR_bg - Jr * h,
            J_dv_ba=s.J_dv_ba - s.dR * h,
            J_dv_bg=s.J_dv_bg - Ra @ s.J_dR_bg * h,
            J_dp_ba=s.J_dp_ba + s.J_dv_ba * h - 0.5 * s.dR * h * h,
            J_dp_bg=s.J_dp_bg + s.J_dv_bg * h - 0.5 * Ra @ s.J_dR_bg * h * h,
            dt=s.dt + h,
        )
        s = select(active[i], new, s)
    return s


@dataclass
class ChunkSummary(Struct):
    """Preintegration of a contiguous sample chunk, closed under composition.

    Besides the chunk's deltas, covariance and stacked bias Jacobians it
    carries the products of its per-sample linear transitions, M9
    (covariance) and M15 (bias Jacobians), so that two adjacent chunks
    compose with ``combine_summary``."""

    dR: torch.Tensor  # (3,3) delta rotation over the chunk
    dv: torch.Tensor  # (3,)
    dp: torch.Tensor  # (3,)
    dt: torch.Tensor  # () chunk duration
    M9: torch.Tensor  # (9,9) product of the covariance transitions
    cov: torch.Tensor  # (9,9) chunk covariance from a zero start
    M15: torch.Tensor  # (15,15) product of the bias-Jacobian transitions
    X: torch.Tensor  # (15,3) [J_dR_bg; J_dv_ba; J_dv_bg; J_dp_ba; J_dp_bg]


def _block_diag3(blocks):
    """(...,3n,3n) block-diagonal matrix of n (...,3,3) blocks."""
    n = len(blocks)
    z3 = torch.zeros_like(blocks[0])
    return torch.cat([torch.cat([b if j == i else z3 for j in range(n)], -1)
                      for i, b in enumerate(blocks)], -2)


def combine_summary(a: ChunkSummary, b: ChunkSummary) -> ChunkSummary:
    """Compose chunk ``a`` (earlier) with chunk ``b`` (later); associative.

    ``b``'s transitions were built with prefix rotations local to its own
    start; in the joined stream each carries the extra left rotation
    ``a.dR``: A_global = G A_local G^T with G = diag(I, a.dR, a.dR) for the
    covariance and diag(I, a.dR x4) for the bias Jacobians.  ``b``'s products
    and covariance are conjugated into the joined frame before the affine
    composition.  Batched over leading dims."""
    eye3 = torch.eye(3, dtype=a.dR.dtype, device=a.dR.device).expand_as(a.dR)
    G9 = _block_diag3([eye3, a.dR, a.dR])
    G15 = _block_diag3([eye3, a.dR, a.dR, a.dR, a.dR])
    M9b = G9 @ b.M9 @ G9.transpose(-1, -2)
    M15b = G15 @ b.M15 @ G15.transpose(-1, -2)
    return ChunkSummary(
        dR=a.dR @ b.dR, dv=a.dv + geo.mv(a.dR, b.dv),
        dp=a.dp + a.dv * b.dt[..., None] + geo.mv(a.dR, b.dp), dt=a.dt + b.dt,
        M9=M9b @ a.M9,
        cov=M9b @ a.cov @ M9b.transpose(-1, -2) + G9 @ b.cov @ G9.transpose(-1, -2),
        M15=M15b @ a.M15, X=M15b @ a.X + G15 @ b.X)


def summary_to_preintegration(s: ChunkSummary, ba, bg) -> Preintegration:
    return Preintegration(dR=s.dR, dv=s.dv, dp=s.dp, cov=s.cov, J_dR_bg=s.X[..., 0:3, :],
                          J_dv_ba=s.X[..., 3:6, :], J_dv_bg=s.X[..., 6:9, :],
                          J_dp_ba=s.X[..., 9:12, :], J_dp_bg=s.X[..., 12:15, :],
                          dt=s.dt, ba_lin=ba, bg_lin=bg)


def associative_scan(combine, elems):
    """Inclusive scan of ``combine`` over the leading axis of every tensor in
    the tuple ``elems``, for any length N, in ceil(log2 N) steps
    (Hillis-Steele): step d combines element i - d with element i for all
    i >= d in one batched call.  ``combine(a, b)`` takes the earlier
    elements first and must be associative."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        new = combine(tuple(x[:-d] for x in elems), tuple(x[d:] for x in elems))
        elems = tuple(torch.cat([x[:d], y]) for x, y in zip(elems, new))
        d *= 2
    return elems


def _combine_delta(ea, eb):
    """The group law of (R, v, p, t)."""
    Ra, va, pa, ta = ea
    Rb, vb, pb, tb = eb
    return Ra @ Rb, va + geo.mv(Ra, vb), pa + va * tb[:, None] + geo.mv(Ra, pb), ta + tb


def _combine_cov(ea, eb):
    """Affine pairs (M, C) of Sigma_k = M_k Sigma_{k-1} M_k^T + C_k."""
    Ma, Ca = ea
    Mb, Cb = eb
    return Mb @ Ma, Mb @ Ca @ Mb.transpose(-1, -2) + Cb


def _combine_affine(ea, eb):
    """Affine pairs (M, c) of X_k = M_k X_{k-1} + c_k."""
    Ma, ca = ea
    Mb, cb = eb
    return Mb @ Ma, Mb @ ca + cb


def chunk_summary(acc, gyr, dt, ba, bg, params: ImuParams) -> ChunkSummary:
    """Composable summary of one sample chunk (see ``ChunkSummary``), by three
    associative scans: the delta group law (whose prefix rotations feed the
    linearized passes), the 9x9 covariance affine pair and the 15x3 stacked
    bias-Jacobian affine pair.  Padding samples (dt == 0) are the group's
    and the affine maps' identities."""
    dtype, dev = acc.dtype, acc.device
    n = acc.shape[0]
    active = dt > 0.0
    h = torch.where(active, dt, torch.zeros_like(dt))
    hs = torch.where(active, dt, torch.ones_like(dt))
    a_c = acc - ba
    wdt = (gyr - bg) * h[:, None]
    dR_inc = geo.so3_exp(wdt)
    Jr = geo.so3_right_jacobian(wdt)

    pR, pv, pp, pt = associative_scan(
        _combine_delta, (dR_inc, a_c * h[:, None], 0.5 * a_c * (h * h)[:, None], h))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dR_prev = torch.cat([eye3[None], pR[:-1]])  # the rotation before each sample

    Ra = dR_prev @ geo.skew(a_c)
    h1 = h[:, None, None]
    dR_incT = dR_inc.transpose(-1, -2)
    eyes = eye3.expand(n, 3, 3)
    z3 = torch.zeros((n, 3, 3), dtype=dtype, device=dev)

    def blocks(rows):
        return torch.cat([torch.cat(r, -1) for r in rows], -2)

    A = blocks([[dR_incT, z3, z3], [-Ra * h1, eyes, z3],
                [-0.5 * Ra * h1 * h1, eyes * h1, eyes]])
    B = blocks([[Jr * h1, z3], [z3, dR_prev * h1], [z3, 0.5 * dR_prev * h1 * h1]])
    q = torch.cat([(params.gyr_noise ** 2 / hs)[:, None].expand(n, 3),
                   (params.acc_noise ** 2 / hs)[:, None].expand(n, 3)], 1)
    C = (B * q[:, None, :]) @ B.transpose(-1, -2)
    M9s, covs = associative_scan(_combine_cov, (A, C))

    # X = [J_dR_bg; J_dv_ba; J_dv_bg; J_dp_ba; J_dp_bg], (15,3)
    M = blocks([[dR_incT, z3, z3, z3, z3], [z3, eyes, z3, z3, z3], [-Ra * h1, z3, eyes, z3, z3],
                [z3, eyes * h1, z3, eyes, z3], [-0.5 * Ra * h1 * h1, z3, eyes * h1, z3, eyes]])
    c = torch.cat([-Jr * h1, -dR_prev * h1, z3, -0.5 * dR_prev * h1 * h1, z3], 1)
    M15s, Xs = associative_scan(_combine_affine, (M, c))
    return ChunkSummary(dR=pR[-1], dv=pv[-1], dp=pp[-1], dt=pt[-1], M9=M9s[-1], cov=covs[-1],
                        M15=M15s[-1], X=Xs[-1])


def preintegrate_assoc(acc, gyr, dt, ba, bg, params: ImuParams):
    """``preintegrate`` in O(log N) depth: ``chunk_summary`` of the whole
    buffer as a ``Preintegration``.  Same deltas, covariance and bias
    Jacobians up to float reassociation."""
    return summary_to_preintegration(chunk_summary(acc, gyr, dt, ba, bg, params), ba, bg)


def bias_corrected_deltas(pre: Preintegration, ba, bg):
    """First-order bias correction; returns (dR', dv', dp') at (ba, bg)."""
    dba = ba - pre.ba_lin
    dbg = bg - pre.bg_lin
    dR = pre.dR @ geo.so3_exp(geo.mv(pre.J_dR_bg, dbg))
    dv = pre.dv + geo.mv(pre.J_dv_ba, dba) + geo.mv(pre.J_dv_bg, dbg)
    dp = pre.dp + geo.mv(pre.J_dp_ba, dba) + geo.mv(pre.J_dp_bg, dbg)
    return dR, dv, dp


def _gravity(like):
    # built on the device (no host copy): [0, 0, -g]
    return torch.nn.functional.pad(
        torch.full((1,), -GRAVITY, dtype=like.dtype, device=like.device), (2, 0))


def predict(pre: Preintegration, R_i, p_i, v_i, ba=None, bg=None, g=None):
    """IMU-only state prediction."""
    if g is None:
        g = _gravity(p_i)
    if ba is not None:
        dR, dv, dp = bias_corrected_deltas(pre, ba, bg)
    else:
        dR, dv, dp = pre.dR, pre.dv, pre.dp
    dt = pre.dt[..., None]
    R_j = R_i @ dR
    v_j = v_i + g * dt + geo.mv(R_i, dv)
    p_j = p_i + v_i * dt + 0.5 * g * dt * dt + geo.mv(R_i, dp)
    return R_j, p_j, v_j


def residual(pre: Preintegration, R_i, p_i, v_i, ba_i, bg_i, R_j, p_j, v_j, g=None):
    """9-dim preintegration residual (r_dR, r_dv, r_dp), batched over pairs."""
    if g is None:
        g = _gravity(p_i)
    dR, dv, dp = bias_corrected_deltas(pre, ba_i, bg_i)
    dt = pre.dt[..., None]
    RiT = R_i.transpose(-1, -2)
    r_R = geo.so3_log(dR.transpose(-1, -2) @ (RiT @ R_j))
    r_v = geo.mv(RiT, v_j - v_i - g * dt) - dv
    r_p = geo.mv(RiT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p], -1)


def sqrt_info(pre: Preintegration, eps_rel: float = 1e-5):
    """Whitening W with W cov W^T = I, from a diagonally equilibrated
    Cholesky factor (batched over leading dims)."""
    cov = pre.cov
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-16))
    Cn = cov / (d[..., :, None] * d[..., None, :])
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    Cn = Cn + eye * eps_rel
    L, info = torch.linalg.cholesky_ex(Cn)
    # a failed factorization yields NaN, as jnp.linalg.cholesky does
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    Ln_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Ln_inv / d[..., None, :]
