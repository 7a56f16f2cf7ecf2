"""Multi-sequence bundle adjustment: B independent windows at once.

Port of ``sadvio_tpu/parallel/multiseq.py``.  Without a mesh the B windows
are one batched program on one device: ``torch.func.vmap`` over the
solver, fed the problems' flat tensor leaves (vmap maps over tensors, not
over the port's dataclasses) and rebuilding the problem inside.  With a 1-D
``("seq",)`` mesh each rank solves its own rows, with no collective, and
the rows are gathered; with a ``(seq, lmk)`` composite mesh each row is
solved landmark-sharded (``parallel/sharding.py``) over its ``lmk``
sub-group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sadvio_tpu_torch.backend import ba
from sadvio_tpu_torch.parallel import sharding
from sadvio_tpu_torch.utils.struct import tree_leaves, tree_map, tree_unflatten


def make_seq_mesh(n_devices=None) -> DeviceMesh:
    """1-D ``("seq",)`` mesh over n ranks (default: all)."""
    return sharding.device_mesh((n_devices or dist.get_world_size(),), ("seq",))


def make_composite_mesh(n_seq, n_lmk) -> DeviceMesh:
    """2-D ``(seq, lmk)`` mesh: sequences over ``seq`` x landmark sharding
    inside each sequence's window BA."""
    return sharding.device_mesh((n_seq, n_lmk), ("seq", "lmk"))


def stack_problems(problems):
    """Stack B same-shape BAProblems into one batched problem."""
    if len({bool(p.opt_lmk_only) for p in problems}) > 1:
        raise ValueError("opt_lmk_only must be the same for every stacked problem")
    return tree_map(lambda *xs: torch.stack(xs), *problems)


def unstack_states(state, B):
    return [tree_map(lambda x: x[i], state) for i in range(B)]


def _solve_vmapped(batched, opts: ba.BAOptions):
    def one(*leaves):
        state, stats = ba._ba_solve_impl(tree_unflatten(batched, leaves), opts, opts.iters)
        return tree_leaves(state), stats

    leaves, stats = torch.func.vmap(one)(*tree_leaves(batched))
    return tree_unflatten(batched.state, leaves), stats


def ba_solve_batch(batched_problem, opts: ba.BAOptions, mesh: DeviceMesh | None = None):
    """Solve the B windows of ``batched_problem``; returns (batched_state,
    batched_stats).  With a mesh every rank passes the whole batch and gets
    the whole result; B must divide by the ``seq`` axis size."""
    if mesh is None:
        return _solve_vmapped(batched_problem, opts)
    B = batched_problem.state.R.shape[0]
    lo, hi = sharding._block(mesh, "seq", B)
    rows = tree_map(lambda x: x[lo:hi], batched_problem)
    if "lmk" in mesh.mesh_dim_names:
        outs = [sharding.ba_solve_sharded(tree_map(lambda x, i=i: x[i], rows), opts, mesh)
                for i in range(hi - lo)]
        state = tree_map(lambda *xs: torch.stack(xs), *[s for s, _ in outs])
        stats = {k: torch.stack([st[k] for _, st in outs]) for k in outs[0][1]}
    else:
        state, stats = _solve_vmapped(rows, opts)
    keys = list(stats)
    _, gathered = sharding.all_reduce([], tree_leaves(state) + [stats[k] for k in keys],
                                      mesh.get_group("seq"), dtype=torch.float64)
    n = len(gathered) - len(keys)
    return tree_unflatten(state, gathered[:n]), dict(zip(keys, gathered[n:]))
