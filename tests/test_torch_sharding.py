"""The landmark-sharded window BA of the port over real spawned ranks,
against the JAX package.

One spawn of 4 gloo CPU processes runs the port's sharded solves on
``__graft_entry__._tiny_problem(K=4, C=2, L=128, P=8)``, its poses,
landmarks and pixels perturbed from a seed, with 8 retained prior slots spread over the landmark blocks (so the
replicated retained positions and the retained-slot reductions are
exercised), converted as tests/test_torch_backend.py converts it:

* the 1-D ``lmk`` mesh (4 ranks);
* the ``(kf, lmk)`` 2x2 mesh (observation tiles of 2 keyframes x 32
  landmarks);
* ``shard_dense`` on the 1-D mesh (the dense rows split over the ranks);
* the composite ``(seq, lmk)`` 2x2 mesh over a batch of 4 perturbed
  problems, and the 1-D ``seq`` mesh over the same batch.

Each is held against the JAX package's single-device ``ba_solve`` and (but
for ``seq``, which is rows of single-device solves) its sharded result on
the same mesh shape, with tests/test_sharding.py's tolerances: t and R 1e-4, landmarks 1e-3, cost rtol 1e-3.  Every rank must
return the same result bit for bit (each takes the same LM branch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sadvio_tpu.backend import ba as jba
from sadvio_tpu.parallel import multiseq as jms, sharding as jsh
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.utils.struct import tree_leaves
from tests import torch_ranks
from tests.test_torch_backend import _port_problem

torch.set_num_threads(2)

N_RANKS = 4
ITERS = 4
B = 4
RETAINED = (3, 20, 37, 50, 64, 90, 101, 127)
PIXEL_NOISE = 0.5  # px: the solved cost sits on the noise, not on float32 rounding

WORKER = r"""
import torch
import torch.distributed as dist

rank, world, (d,) = join_group()  # defined ahead of this source by tests/torch_ranks.py
torch.set_num_threads(1)
from sadvio_tpu_torch.backend import ba
from sadvio_tpu_torch.parallel import multiseq, sharding

probs = torch.load(f"{d}/problems.pt", weights_only=False)
opts = ba.BAOptions(iters=probs["iters"])
out = {}
for name, mesh, dense in (("lmk", sharding.make_mesh(4), False),
                          ("kf_lmk", sharding.make_mesh2d(2, 2), False),
                          ("dense", sharding.make_mesh(4), True)):
    out[name] = sharding.ba_solve_sharded(probs["single"], opts, mesh, shard_dense=dense)
batched = multiseq.stack_problems(probs["batch"])
out["composite"] = multiseq.ba_solve_batch(batched, opts, multiseq.make_composite_mesh(2, 2))
out["seq"] = multiseq.ba_solve_batch(batched, opts, multiseq.make_seq_mesh(4))
torch.save(out, f"{d}/out_{rank}.pt")
dist.destroy_process_group()
print(f"rank {rank} done", flush=True)
"""


def spawn(worker, n, args, workdir):
    """``torch_ranks.spawn``; its report of every rank's exit code and log
    tail becomes the test's failure message."""
    try:
        torch_ranks.spawn(worker, n, args, workdir)
    except torch_ranks.RanksFailed as e:
        pytest.fail(str(e), pytrace=False)


def _problem(seed):
    """The tiny problem, its poses and landmarks perturbed, 8 slots retained."""
    jp = graft._tiny_problem(K=4, C=2, L=128, P=8, seed=seed)
    rng = np.random.default_rng(100 + seed)
    dp = (rng.standard_normal((4, 6)) * 0.02).astype(np.float32)
    dp[0] = 0.0
    R, t = jgeo.pose_retract(jp.state.R, jp.state.t, jnp.asarray(dp))
    lmk = jp.state.lmk + jnp.asarray(rng.standard_normal((128, 3)) * 0.05, jnp.float32)
    priors = jp.priors.replace(prior_slots=jnp.asarray(RETAINED, jnp.int32),
                               prior_slot_mask=jnp.ones((8,), bool))
    obs = jp.obs.replace(uv=jp.obs.uv + jnp.asarray(
        rng.standard_normal(jp.obs.uv.shape) * PIXEL_NOISE, jnp.float32))
    return jp._replace(state=jp.state.replace(R=R, t=t, lmk=lmk), obs=obs, priors=priors)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    single = _problem(0)
    batch = [_problem(s) for s in range(B)]
    torch.save({"single": _port_problem(single), "batch": [_port_problem(p) for p in batch],
                "iters": ITERS}, d / "problems.pt")
    spawn(WORKER, N_RANKS, [d], d)
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(N_RANKS)]
    return dict(single=single, batch=batch, outs=outs)


def _np_state(state):
    return {k: np.asarray(getattr(state, k)) for k in ("R", "t", "lmk", "lmk_mask")}


def _close(got, ref, cost_got, cost_ref):
    np.testing.assert_allclose(got["t"], ref["t"], atol=1e-4)
    np.testing.assert_allclose(got["R"], ref["R"], atol=1e-4)
    lm = ref["lmk_mask"]
    np.testing.assert_allclose(got["lmk"][lm], ref["lmk"][lm], atol=1e-3)
    np.testing.assert_allclose(float(cost_got), float(cost_ref), rtol=1e-3)


def _same_on_every_rank(outs, name):
    first = outs[0][name]
    for o in outs[1:]:
        for a, b in zip(_flat(first), _flat(o[name])):
            assert torch.equal(a, b), name


def _flat(res):
    state, stats = res
    return tree_leaves(state) + [stats[k] for k in sorted(stats)]


@pytest.mark.parametrize("case", ["lmk", "kf_lmk", "dense"])
def test_sharded_solve_matches_jax(port_runs, case):
    _same_on_every_rank(port_runs["outs"], case)
    state, stats = port_runs["outs"][0][case]
    got = _np_state(state)
    prob = port_runs["single"]
    opts = jba.BAOptions(iters=ITERS)
    ref, ref_stats = jba.ba_solve(prob, opts)
    _close(got, _np_state(ref), stats["cost"], ref_stats["cost"])
    if case == "kf_lmk":
        js, jst = jba.ba_solve(jsh.shard_problem(prob, jsh.make_mesh2d(2, 2)), opts)
    else:
        js, jst = jsh.ba_solve_sharded(prob, opts, jsh.make_mesh(4), shard_dense=case == "dense")
    _close(got, _np_state(js), stats["cost"], jst["cost"])
    np.testing.assert_array_equal(stats["accepted"].numpy(), np.asarray(ref_stats["accepted"]))


@pytest.fixture(scope="module")
def jax_batch_refs(port_runs):
    opts = jba.BAOptions(iters=ITERS)
    return [jba.ba_solve(prob, opts) for prob in port_runs["batch"]]


@pytest.mark.parametrize("case", ["composite", "seq"])
def test_batched_meshes_match_jax(port_runs, jax_batch_refs, case):
    _same_on_every_rank(port_runs["outs"], case)
    bstate, bstats = port_runs["outs"][0][case]
    if case == "composite":
        jstate, jstats = jms.ba_solve_batch(jms.stack_problems(port_runs["batch"]),
                                            jba.BAOptions(iters=ITERS),
                                            jms.make_composite_mesh(2, 2))
    for i, (ref, ref_stats) in enumerate(jax_batch_refs):
        got = {k: v[i] for k, v in _np_state(bstate).items()}
        _close(got, _np_state(ref), bstats["cost"][i], ref_stats["cost"])
        if case == "composite":
            _close(got, {k: v[i] for k, v in _np_state(jstate).items()}, bstats["cost"][i],
                   jstats["cost"][i])
