"""The whole pyramidal track of the port (``lk_track`` / ``lk_track_ref``, the
plain version the fused CUDA kernel is checked against) against the JAX
package's ``klt.track``, and the semantics the kernel has to keep.

The JAX side runs ``engine="gather"``: ``track`` cannot pass ``interpret``
through to the Pallas kernel, and the gather engine is the JAX package's
portable form of the same loop (the Pallas kernel itself is held to the
port's loop in tests/test_torch_klt_kernel.py).  It runs a fixed iteration
count where the port stops a feature once its step is under eps, so the
port runs with eps = 1e-3 px here.  Tolerances on features valid in both:
median |duv| < 0.05 px and max |duv| < 1e-2 px (float32, another summation
order, window clamps that differ at the image edge); the valid masks agree
except where the forward-backward distance or the residual is within those
tolerances of its gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import klt as jklt
from sadvio_tpu.frontend.detect import bilinear_sample
from sadvio_tpu_torch.frontend import klt as tklt
from sadvio_tpu_torch.ops import klt_kernel as tkern

torch.set_num_threads(2)

H, W = 96, 320
R = 5
N = 32


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """Blocky texture, its (2.5, -1.25) px shift, and N features of which
    two sit at the border."""
    rng = np.random.default_rng(7)
    img = np.kron(rng.standard_normal((H // 4, W // 4)), np.ones((4, 4)))
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        img = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), ax, img)
    img0 = jnp.asarray((img - img.min()) / (img.max() - img.min()) * 200.0, jnp.float32)
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
                          indexing="ij")
    img1 = bilinear_sample(img0, jnp.stack([xs + 2.5, ys - 1.25], -1))
    rng = np.random.default_rng(4)
    uv0 = np.stack([rng.uniform(40, 280, N), rng.uniform(30, 66, N)], -1).astype(np.float32)
    uv0[0] = [2.0, 50.0]
    uv0[1] = [200.0, H - 2.0]
    warp = (np.eye(2, dtype=np.float32) * rng.uniform(0.95, 1.06, (N, 1, 1))
            + rng.uniform(-0.03, 0.03, (N, 2, 2))).astype(np.float32)
    return dict(img0=img0, img1=img1, uv0=uv0, warp=warp, valid0=np.ones(N, bool))


def _pyrs(scene, levels, lib):
    if lib == "jax":
        return jklt.build_pyramid(scene["img0"], levels), jklt.build_pyramid(scene["img1"], levels)
    return (tklt.build_pyramid(_t(scene["img0"]), levels),
            tklt.build_pyramid(_t(scene["img1"]), levels))


def _ref(scene, levels=3, warp=None, uv_init=None, valid0=None, **kw):
    p0, p1 = _pyrs(scene, levels, "torch")
    uv_init = scene["uv0"] if uv_init is None else uv_init
    valid0 = scene["valid0"] if valid0 is None else valid0
    return tkern.lk_track_ref(p0, p1, _t(scene["uv0"]), _t(uv_init), _t(valid0),
                              None if warp is None else _t(warp), levels=levels, radius=R, **kw)


@pytest.mark.parametrize("warped", [False, True])
def test_ref_matches_jax_track(scene, warped):
    warp = scene["warp"] if warped else None
    p0, p1 = _pyrs(scene, 3, "jax")
    uv_j, v_j, e_j = jklt.track(p0, p1, jnp.asarray(scene["uv0"]), jnp.asarray(scene["uv0"]),
                                jnp.asarray(scene["valid0"]), levels=3, radius=R,
                                engine="gather", warp=None if warp is None else jnp.asarray(warp))
    uv_t, v_t, e_t = _ref(scene, warp=warp, eps=1e-3)
    # gate ties: re-run the port with both gates moved by the tolerance
    tight = _ref(scene, warp=warp, eps=1e-3, fb_thresh=0.5 - 1e-2, max_err=20.0 - 1e-2)[1]
    loose = _ref(scene, warp=warp, eps=1e-3, fb_thresh=0.5 + 1e-2, max_err=20.0 + 1e-2)[1]
    v_j = np.asarray(v_j)
    assert (v_j | ~tight.numpy()).all() and (loose.numpy() | ~v_j).all()
    both = v_j & v_t.numpy()
    assert both.sum() > 0.6 * N
    assert not both[0] and not both[1]  # the border features
    d = np.linalg.norm(uv_t.numpy() - np.asarray(uv_j), axis=-1)[both]
    assert np.median(d) < 0.05 and d.max() < 1e-2, (np.median(d), d.max())
    np.testing.assert_allclose(e_t.numpy()[both], np.asarray(e_j)[both], atol=1e-2)
    truth = scene["uv0"] - [2.5, -1.25]
    assert np.median(np.linalg.norm(uv_t.numpy() - truth, axis=-1)[both]) < 0.15


def test_template_window_cache_changes_nothing(scene):
    """The cached windows are a copy of pyr0, so a track that reads pyr0
    itself (as the fused kernel does) gives the same bits."""
    p0, _ = _pyrs(scene, 3, "torch")
    wins = tklt.template_windows_pyr(p0, _t(scene["uv0"]), 3, R)
    a = _ref(scene, warp=scene["warp"])
    b = _ref(scene, warp=scene["warp"], tmpl_wins=wins)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bwd_levels", [1, 2])
@pytest.mark.parametrize("levels", [1, 3, 4])
def test_engines_agree_on_the_cpu(scene, levels, bwd_levels):
    if bwd_levels > levels:
        bwd_levels = levels
    p0, p1 = _pyrs(scene, levels, "torch")
    args = (p0, p1, _t(scene["uv0"]), _t(scene["uv0"] + 0.5), _t(scene["valid0"]))
    kw = dict(levels=levels, radius=R, warp=_t(scene["warp"]), bwd_levels=bwd_levels)
    before = tkern.lk_track.launches, tkern.lk_iterate.launches
    fused = tklt.track(*args, engine="fused", **kw)
    per_level = tklt.track(*args, engine="levels", **kw)
    assert (tkern.lk_track.launches, tkern.lk_iterate.launches) == before  # CPU: no launch
    for x, y in zip(fused, per_level):
        assert torch.equal(x, y)
    assert fused[1].sum() > 0.4 * N
    with pytest.raises(ValueError):
        tklt.track(*args, engine="batched", **kw)


def test_nan_start_stays_nan_and_leaves_the_others(scene):
    init = scene["uv0"].copy()
    init[5] = np.nan
    uv, valid, err = _ref(scene, uv_init=init)
    uv_c, valid_c, err_c = _ref(scene)
    assert torch.isnan(uv[5]).all() and torch.isnan(err[5]) and not valid[5]
    keep = torch.arange(N) != 5
    assert torch.equal(uv[keep], uv_c[keep]) and torch.equal(valid[keep], valid_c[keep])
    assert torch.equal(err[keep], err_c[keep])


def test_bad_warps_count_as_identity(scene):
    warp = np.broadcast_to(np.eye(2, dtype=np.float32), (N, 2, 2)).copy()
    warp[3] = [[1.0, 2.0], [0.5, 1.0]]  # singular
    warp[4] = [[3.0, 0.0], [0.0, 3.0]]  # det 9, outside (0.25, 4)
    warp[6] = [[0.4, 0.0], [0.0, 0.4]]  # det 0.16
    warp[7] = [[np.nan, 0.0], [0.0, 1.0]]
    warp[8] = [[np.inf, 0.0], [0.0, 1.0]]
    for x, y in zip(_ref(scene, warp=warp), _ref(scene, warp=None)):
        assert torch.equal(x, y)


def test_border_feature_fails_the_in_bounds_gate(scene):
    uv, valid, _ = _ref(scene)
    assert not valid[0] and not valid[1]
    assert valid[2:].sum() > 0.6 * N


def test_valid0_false_never_comes_back(scene):
    valid0 = scene["valid0"].copy()
    valid0[::3] = False
    _, valid, _ = _ref(scene, valid0=valid0)
    _, valid_all, _ = _ref(scene)
    assert not valid[::3].any()
    assert torch.equal(valid, valid_all & _t(valid0))


@pytest.mark.parametrize("bad", ["dtype", "valid_dtype", "device", "big_patch", "strided_level",
                                 "level_dims", "bwd_levels", "uv_shape"])
def test_lk_track_rejects_what_the_kernel_does_not_take(scene, bad):
    p0, p1 = _pyrs(scene, 3, "torch")
    a = dict(pyr0=list(p0), pyr1=list(p1), uv0=_t(scene["uv0"]), uv_init=_t(scene["uv0"]),
             valid0=_t(scene["valid0"]), warp=_t(scene["warp"]))
    kw = dict(levels=3, radius=R)
    if bad == "dtype":
        a["uv_init"] = a["uv_init"].double()
    elif bad == "valid_dtype":
        a["valid0"] = a["valid0"].float()
    elif bad == "device":
        a["warp"] = a["warp"].to("meta")
    elif bad == "big_patch":
        kw["radius"] = (tkern.MAX_S + 1) // 2
    elif bad == "strided_level":
        a["pyr1"][1] = torch.zeros((W // 2, H // 2)).T
        assert tuple(a["pyr1"][1].shape) == tuple(p1[1].shape)
    elif bad == "level_dims":
        a["pyr0"][2] = torch.zeros((H // 4 + 1, W // 4))
    elif bad == "bwd_levels":
        kw["bwd_levels"] = 4
    else:
        a["uv_init"] = a["uv_init"][:-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        tkern.lk_track(*a.values(), **kw)


def test_lk_iterate_rejects_an_even_patch():
    n, s = 4, 10
    z = torch.zeros
    with pytest.raises(ValueError):
        tkern.lk_iterate(z((40, 60)), z((n, 2)), z((n, s, s)), z((n, s, s)), z((n, s, s)),
                         z((n, 4)), iters=2)


@pytest.mark.parametrize("entry", ["make_rig", "make_world", "StereoSLAM"])
def test_no_device_means_the_card(entry):
    """device=None at an entry point is the CUDA card: without one it raises
    and never carries on on the CPU; device="cpu" runs."""
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    rig = synthetic.make_rig(device="cpu")
    calls = {
        "make_rig": lambda **k: synthetic.make_rig(**k).t_f_s,
        "make_world": lambda **k: synthetic.make_world(n_frames=1, width=64, height=48,
                                                       n_points=20, **k).rig.t_f_s,
        "StereoSLAM": lambda **k: StereoSLAM(rig, SLAMConfig(slam_mode="bimono"), **k).rig.t_f_s,
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert calls[entry](device="cpu").device.type == "cpu"
