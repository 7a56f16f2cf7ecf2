"""Landmark-sharded window BA over a ``torch.distributed`` device mesh.

Port of ``sadvio_tpu/parallel/sharding.py``.  The landmarks (and their
observation columns) are split into contiguous blocks over the mesh's
``lmk`` axis: per-landmark Schur elimination is independent, and the
reduced camera system (K*15 + P*3 dims) is a sum over landmarks.  In the
JAX package GSPMD inserts the psum; here every collective is written out:

| Quantity | Where it lives | Collective |
| --- | --- | --- |
| Hll, bl, Hpl, W_kl, landmark back-substitution | the shard | none |
| Hpp, bp, retained-slot blocks, reprojection cost | sums over L | one all_reduce per linearization over ``lmk`` |
| Hred_corr, bred_corr | sums over L | one all_reduce per solve over ``lmk`` |
| dense ``jacfwd`` block, Cholesky | replicated | none |

The retained landmarks' positions (P,3) ride along replicated, updated from
the replicated dense step, so the dense block needs no collective; the LM
accept/reject reads only all-reduced or replicated values, so every rank
takes the same branch.  With ``shard_dense`` the dense block's residual
rows are split over the ``lmk`` ranks: each forms J^T J and J^T r of its
own rows, and they join the linearization's all_reduce.

On a 2-D ``(kf, lmk)`` mesh each rank holds a (K/nk, C, L/nl) tile of the
observation table: Hll, bl and the cost sum over the ``kf`` group and Hpl,
Hpp, bp gather over it (one all_reduce), after which every rank holds its
landmark block at all keyframes and the ``lmk`` reductions follow.

Every gather is an all_reduce of a zero-filled buffer in which each rank
writes its own rows, so one code path serves every backend: gloo on CPU
processes, NCCL with a card per rank, and gloo over CUDA tensors for ranks
sharing one card (NCCL refuses two ranks on one GPU; gloo reduces CUDA
tensors).  Every rank of the mesh calls a solve with the same full problem.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sadvio_tpu_torch.backend import ba
from sadvio_tpu_torch.data.window import Observations, WindowState


def device_mesh(shape, names) -> DeviceMesh:
    """A mesh over the first prod(shape) ranks of the default process group,
    row-major.  Its device type is where the collectives reduce: "cuda"
    under NCCL, "cpu" under gloo (which reduces on the host, CUDA tensors
    included)."""
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"need {n} ranks, have {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(names))


def make_mesh(n_devices=None) -> DeviceMesh:
    """1-D ``("lmk",)`` mesh over n ranks (default: all)."""
    return device_mesh((n_devices or dist.get_world_size(),), ("lmk",))


def make_mesh2d(n_kf, n_lmk) -> DeviceMesh:
    """2-D ``(kf, lmk)`` mesh: keyframe rows x landmark columns of the
    observation table.  Keep n_kf small: the reduced solve is replicated."""
    return device_mesh((n_kf, n_lmk), ("kf", "lmk"))


def all_reduce(sums, gathers, group, dtype=None):
    """One all_reduce over ``group``: each tensor of ``sums`` summed over the
    ranks, each of ``gathers`` concatenated along dim 0 in rank order.  The
    tensors travel packed as ``dtype`` (default: the first one's) and come
    back in their own dtypes; float64 packs float32, int and bool exactly."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    parts = list(sums)
    for g in gathers:
        buf = g.new_zeros((n * g.shape[0], *g.shape[1:]))
        buf[r * g.shape[0]:(r + 1) * g.shape[0]] = g
        parts.append(buf)
    flat = torch.cat([p.reshape(-1).to(dtype or parts[0].dtype) for p in parts])
    dist.all_reduce(flat, group=group)
    out = [x.reshape(p.shape).to(p.dtype)
           for x, p in zip(flat.split([p.numel() for p in parts]), parts)]
    return out[:len(sums)], out[len(sums):]


def _block(mesh: DeviceMesh, name: str, n_items: int):
    """(lo, hi) of this rank's contiguous block of ``n_items`` along mesh
    axis ``name``."""
    n = mesh[name].size()
    if n_items % n:
        raise ValueError(f"{n_items} not divisible by the {name!r} axis size {n}")
    size = n_items // n
    lo = mesh.get_local_rank(name) * size
    return lo, lo + size


def shard_problem(problem: ba.BAProblem, mesh: DeviceMesh) -> ba.BAProblem:
    """This rank's part of ``problem``: its contiguous block of L/nl
    landmarks (``state.lmk*`` and the observation table's landmark columns)
    and, on a (kf, lmk) mesh, the K/nk keyframe rows of the observation
    table.  Poses, IMU, priors, rig and lines stay whole (replicated)."""
    lo, hi = _block(mesh, "lmk", problem.state.L)
    k0, k1 = (_block(mesh, "kf", problem.state.K) if "kf" in mesh.mesh_dim_names
              else (0, problem.state.K))
    st = problem.state
    state = st.replace(lmk=st.lmk[lo:hi], lmk_mask=st.lmk_mask[lo:hi],
                       lmk_flags=st.lmk_flags[lo:hi])
    obs = Observations(uv=problem.obs.uv[k0:k1, :, lo:hi], mask=problem.obs.mask[k0:k1, :, lo:hi])
    return problem._replace(state=state, obs=obs)


@dataclass
class _ShardState(WindowState):
    """A shard's window state plus the replicated positions of the P
    prior-retained landmarks (which may live on another shard)."""

    pl: torch.Tensor = None  # (P,3)


def ba_solve_sharded(problem: ba.BAProblem, opts: ba.BAOptions, mesh: DeviceMesh,
                     shard_dense: bool = False):
    """The window BA with landmarks sharded over the mesh's ``lmk`` axis (and
    the observation table's keyframe rows over ``kf`` if the mesh has one).
    Every rank of the mesh calls it with the same full problem; it returns
    (state, stats) with the landmarks gathered, identical on every rank."""
    if shard_dense:
        opts = opts.replace(dense_shard=True)
    local = shard_problem(problem, mesh)
    lmk_group = mesh.get_group("lmk")
    lo, hi = _block(mesh, "lmk", problem.state.L)
    two_d = "kf" in mesh.mesh_dim_names
    k0, k1 = _block(mesh, "kf", problem.state.K) if two_d else (0, problem.state.K)
    K, P = problem.state.K, problem.priors.P
    KD, off_l = K * ba.D, K * ba.D + P * 3

    # this shard's view of the retained slots: slot indices local to its block
    pr = problem.priors
    in_blk = pr.prior_slot_mask & (pr.prior_slots >= lo) & (pr.prior_slots < hi)
    priors_l = pr.replace(prior_slot_mask=in_blk, prior_slots=pr.prior_slots - lo)
    slot = ba.slot_of_lmk(priors_l, hi - lo)
    elim_base = ~(slot < P)

    def linearize(prob):
        st = prob.state
        tile = st.replace(R=st.R[k0:k1], t=st.t[k0:k1], kf_mask=st.kf_mask[k0:k1])
        Hll, bl, Hpl, Hpp, bp, c = ba._lmk_normal_eqs(tile, prob.obs, prob.rig, opts)
        if two_d:
            (Hll, bl, c), (Hpl, Hpp, bp) = all_reduce([Hll, bl, c], [Hpl, Hpp, bp],
                                                      mesh.get_group("kf"))
        Hll_ret, bl_ret, Hx = ba._retained_blocks(slot, st.lmk_mask, P, Hll, bl, Hpl)
        r, J = ba._dense_jac(prob, st.pl, opts)
        if opts.dense_shard:
            rows = torch.tensor_split(torch.arange(r.shape[0], device=r.device),
                                      lmk_group.size())[dist.get_rank(lmk_group)]
            r, J = r[rows], J[rows]
        HJ, bJ, sq = J.T @ J, -J.T @ r, torch.sum(r * r)
        sums = [Hpp, bp, Hll_ret, bl_ret, Hx, c] + ([HJ, bJ, sq] if opts.dense_shard else [])
        sums, _ = all_reduce(sums, [], lmk_group)
        Hpp, bp, Hll_ret, bl_ret, Hx, c = sums[:6]
        if opts.dense_shard:
            HJ, bJ, sq = sums[6:]
        H, b = ba._assemble(HJ, bJ, K, P, Hpp, bp, Hll_ret, bl_ret, Hx)
        return ba._Lin(Hll, bl, Hpl, Hpp, bp, H, b, c + sq)

    def solve(lin, prob, free, lam):
        elim = prob.state.lmk_mask & elim_base
        Hll_inv, bl_e, Hpl_e, Hred, bred = ba._schur_terms(lin.Hll, lin.bl, lin.Hpl, elim, lam,
                                                           opts)
        (Hred, bred), _ = all_reduce([Hred, bred], [], lmk_group)
        dxd, ok = ba._reduced_step(lin.H, lin.b, Hred, bred, free, lam, opts)
        return dxd, ba._back_substitute(Hll_inv, bl_e, Hpl_e, dxd, elim), ok

    def retract(st, dxd, dl):
        trial = ba._apply_dense_delta(st, priors_l, dxd)
        dlp = dxd[KD:off_l].reshape(P, 3)
        pl = st.pl + torch.where(pr.prior_slot_mask[:, None], dlp, torch.zeros_like(dlp))
        return trial.replace(lmk=trial.lmk + dl, pl=pl)

    st = local.state
    st = _ShardState(**{f.name: getattr(st, f.name) for f in fields(WindowState)},
                     pl=ba._retained_lmk(problem.state, pr))
    state, stats = ba._lm(local._replace(state=st), opts, opts.iters, linearize, solve, retract)
    _, (lmk,) = all_reduce([], [state.lmk], lmk_group)
    full = problem.state.replace(**{f.name: getattr(state, f.name) for f in fields(WindowState)})
    return full.replace(lmk=lmk, lmk_mask=problem.state.lmk_mask,
                        lmk_flags=problem.state.lmk_flags), stats
