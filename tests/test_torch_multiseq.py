"""The port's multi-sequence batch BA without a mesh: B windows solved as
one batched program (``torch.func.vmap`` over the solver), against B
separate solves and against the JAX package's ``ba_solve_batch``.

Inputs: ``__graft_entry__._tiny_problem(K=4, C=2, L=64, P=8, seed=s)`` for
s = 0..7 (tests/test_sharding.py's batch), converted as
tests/test_torch_backend.py converts it, with seeded pose and landmark
perturbations so that every row has work to do.  Tolerance: 1e-4 on t and
R (tests/test_sharding.py's), 1e-3 on landmarks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sadvio_tpu.backend import ba as jba
from sadvio_tpu.parallel import multiseq as jms
from sadvio_tpu.utils import geometry as jgeo
from sadvio_tpu_torch.backend import ba as tba
from sadvio_tpu_torch.parallel import multiseq as tms
from tests.test_torch_backend import _port_problem

torch.set_num_threads(2)

B = 8
ITERS = 3


def _problem(seed):
    jp = graft._tiny_problem(K=4, C=2, L=64, P=8, seed=seed)
    rng = np.random.default_rng(200 + seed)
    dp = (rng.standard_normal((4, 6)) * 0.02).astype(np.float32)
    dp[0] = 0.0
    R, t = jgeo.pose_retract(jp.state.R, jp.state.t, jnp.asarray(dp))
    lmk = jp.state.lmk + jnp.asarray(rng.standard_normal((64, 3)) * 0.05, jnp.float32)
    return jp._replace(state=jp.state.replace(R=R, t=t, lmk=lmk))


@pytest.fixture(scope="module")
def runs():
    jprobs = [_problem(s) for s in range(B)]
    tprobs = [_port_problem(p) for p in jprobs]
    calls = []
    orig = tba._ba_solve_impl

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tba._ba_solve_impl = counted
    try:
        bstate, bstats = tms.ba_solve_batch(tms.stack_problems(tprobs), tba.BAOptions(iters=ITERS))
    finally:
        tba._ba_solve_impl = orig
    jstate, jstats = jms.ba_solve_batch(jms.stack_problems(jprobs), jba.BAOptions(iters=ITERS))
    return dict(tprobs=tprobs, bstate=bstate, bstats=bstats, jstate=jstate, jstats=jstats,
                calls=len(calls))


def test_batch_is_one_program(runs):
    assert runs["calls"] == 1
    assert runs["bstate"].t.shape == (B, 4, 3)
    assert runs["bstats"]["accepted"].shape == (B, ITERS)


@pytest.mark.parametrize("i", range(B))
def test_row_matches_individual_and_jax(runs, i):
    got = tms.unstack_states(runs["bstate"], B)[i]
    ref, ref_stats = tba.ba_solve(runs["tprobs"][i], tba.BAOptions(iters=ITERS))
    for name, tol in (("t", 1e-4), ("R", 1e-4), ("lmk", 1e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(ref, name).numpy(),
                                   atol=tol, err_msg=name)
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(runs["jstate"], name))[i], atol=tol,
                                   err_msg=name)
    np.testing.assert_array_equal(runs["bstats"]["accepted"][i].numpy(),
                                  ref_stats["accepted"].numpy())


def test_mixed_landmark_only_flags_refused(runs):
    p = runs["tprobs"]
    with pytest.raises(ValueError, match="opt_lmk_only"):
        tms.stack_problems([p[0], p[1]._replace(opt_lmk_only=True)])
