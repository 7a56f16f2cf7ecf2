"""The port's stereo VIO on the hardened world, against the JAX package.

tests/test_pipeline_stress.py's hardened world (seed 9, 40 frames, pixel
noise 2, exposure flicker +-12% / +-8, the occluder) through the port: no
reset and ATE < 0.08 m (the JAX test's gates).  At the run's frame track
where the max_err gate rejects most (LK's residual is not gain-invariant,
so an exposure step between keyframe and frame lifts the mean absolute
residual over 20; it rejects 13% of the live features on average here,
76% at frame 11), the port's plain track (lk_track_ref, what the CUDA
kernel is held to on the card) and the JAX package's klt.track (the gather
engine, as tests/test_torch_klt_track.py runs it, and with its tolerances)
reject the same features: the valid masks agree but where the
forward-backward distance or the residual is within 1e-2 of its gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import klt as jklt
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu_torch.frontend import klt as tklt
from sadvio_tpu_torch.ops import klt_kernel as tkern
from tests.test_torch_stress_pipeline import _ate, _port_slam

torch.set_num_threads(2)

HARDENED = dict(seed=9, n_frames=40, width=320, height=240, n_points=200, imu_noise=True,
                noise_px=2.0, gain_jitter=0.12, offset_jitter=8.0, occluder=True)
GATE_TIE = 1e-2  # tests/test_torch_klt_track.py's tolerance at the two gates


@pytest.fixture(scope="module")
def hardened():
    """The port over the hardened world, keeping every frame track's inputs."""
    world = jsyn.make_world(**HARDENED)
    ts = _port_slam(world)
    calls, own = [], tklt.track

    def keep(*a, **k):
        if k.get("warp") is not None:
            calls.append((a, k))
        return own(*a, **k)

    tklt.track = keep
    try:
        outs = [ts.process_frame(f) for f in world.frames]
    finally:
        tklt.track = own
    return dict(world=world, slam=ts, outs=outs, calls=calls)


def test_hardened_world_passes_the_jax_gates(hardened):
    ts, world = hardened["slam"], hardened["world"]
    assert ts.n_resets == 0, "stress world should not force a reset"
    assert _ate(ts, world) < 0.08
    assert len(hardened["calls"]) == len(world.frames) - 1  # one frame track per frame


def test_klt_gates_on_a_flickered_frame_match_jax(hardened):
    world, calls, outs = hardened["world"], hardened["calls"], hardened["outs"]
    levels, radius = 3, 5

    def track_ref(call, **kw):
        (p0, p1, uv0, init, valid0), k = call
        return tkern.lk_track_ref(p0, p1, uv0, init, valid0, k["warp"], levels=levels,
                                  radius=radius, eps=1e-3, **kw)

    def err_share(call):
        """Live features the max_err gate alone rejects: valid with that gate
        open, mean absolute residual at or over it."""
        _, valid, err = track_ref(call, max_err=np.inf)
        return float((valid & (err >= 20.0)).sum() / max(int(call[0][4].sum()), 1))

    shares = [err_share(c) for c in calls]
    i = int(np.argmax(shares))
    assert shares[i] > 0.3, shares  # the max_err gate fires on flicker
    f = i + 1
    kf = max(j for j in range(f) if outs[j]["is_kf"])
    (_, _, uv0, init, valid0), k = calls[i]
    pj = [jklt.build_pyramid(jnp.asarray(world.frames[g].images[0]), levels) for g in (kf, f)]
    pt = [tklt.build_pyramid(torch.as_tensor(world.frames[g].images[0]), levels) for g in (kf, f)]
    for a, b in zip(pt[0], calls[i][0][0]):
        assert torch.equal(a, b)  # the pipeline tracked these images
    call = ((pt[0], pt[1], uv0, init, valid0), k)
    uv_t, v_t, e_t = track_ref(call)
    tight = track_ref(call, fb_thresh=0.5 - GATE_TIE, max_err=20.0 - GATE_TIE)[1].numpy()
    loose = track_ref(call, fb_thresh=0.5 + GATE_TIE, max_err=20.0 + GATE_TIE)[1].numpy()
    j_args = [jnp.asarray(x.numpy()) for x in (uv0, init, valid0, k["warp"])]
    uv_j, v_j, e_j = jklt.track(pj[0], pj[1], *j_args[:3], levels=levels, radius=radius,
                                engine="gather", warp=j_args[3])
    v_j = np.asarray(v_j)
    assert (v_j | ~tight).all() and (loose | ~v_j).all()
    v_j_open = np.asarray(jklt.track(pj[0], pj[1], *j_args[:3], levels=levels, radius=radius,
                                     engine="gather", warp=j_args[3], max_err=np.inf)[1])
    assert (v_j_open & ~v_j).sum() >= 0.9 * shares[i] * int(valid0.sum())
    both = v_j & v_t.numpy()
    assert both.sum() > 0
    d = np.linalg.norm(uv_t.numpy() - np.asarray(uv_j), axis=-1)[both]
    assert np.median(d) < 0.05 and d.max() < 1e-2, (np.median(d), d.max())
