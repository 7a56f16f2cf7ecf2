"""The monocular VIO deployment (``portbench/configs/euroc_mono_vio.json``,
the benchmark's ``mono_vio.replay`` mix) on the CPU.

* VIInit on the card run's own window (ROADMAP C11): the arguments of the
  first VIInit call of that configuration on the ``replay`` mix, seed
  9600000002, on an NVIDIA H100 (``tests/data/card_mono_vi_init.npz``:
  keyframes at frames 0, 3, 4, 25, 34 and 41; the 1 s timer closed the
  4 -> 25 link at 1.05 s, so the 1 s gap gate left it out of the chain).  Over the chain as the BA has it,
  both packages' solves put the scale at about a tenth of the truth with
  the accelerometer bias inside the 1 m/s^2 gate, so the JAX package takes
  it; the run then lost its tracks and reset at frame 49.  The port's
  monocular VIInit also solves over the links the gate dropped
  (``MonoSLAM._vi_init_chain``) and refuses a scale the window does not
  see: one that, held at half its value, would not double the cost
  (``StereoSLAM._run_vi_init``, ``SCALE_SEEN``).
* The bootstrap on a faulty essential fit (``tests/data/mono_boot_fit.npz``):
  the same configuration and mix, seed 4436087053, RANSAC stream 20 on the
  CPU, where frame 2's fit read ``ok`` over the parallax threshold with 20
  of its 188 tracks as inliers.  The JAX package's rule bootstraps on it; on
  the card the same fault (35 of 173) left 34 landmarks, PnP failed six
  frames running and the run reset at frame 10.  The port refuses a fit
  that fewer than half the tracks agree with (``BOOT_CONSENSUS``).
* The keyframe insertion is a captured stage, makes no host read, records
  one ``_insert_kf`` span per keyframe and the ``kf.landmarks`` /
  ``kf.born`` counts, and agrees with the benchmark's plain reference
  (``portbench/reference``, ``MonoStages``) on the run's own inputs, as
  does the window BA: a 320x240 run (L=160, K=5, 0.5 deg keyframe
  parallax) through the bootstrap and three keyframes.
"""

import dataclasses
import json
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import check, hooks as bench_hooks, program, world as world_mod
from portbench.reference import build as ref_build, stages as ref_stages
from sadvio_tpu.backend import viinit as jvi
from sadvio_tpu.data.window import ImuChain as JImuChain
from sadvio_tpu.models import imu as jimu
from sadvio_tpu_torch.backend import viinit as tvi
from sadvio_tpu_torch.data.window import ImuChain
from sadvio_tpu_torch.models import imu as timu
from sadvio_tpu_torch.pipeline import mono as mono_mod
from sadvio_tpu_torch.pipeline.mono import MonoSLAM
from tests.test_torch_graphs import _HostSyncs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "portbench" / "configs" / "euroc_mono_vio.json").read_text())
CARD_VI_INIT = Path(__file__).with_name("data") / "card_mono_vi_init.npz"
BOOT_FIT = Path(__file__).with_name("data") / "mono_boot_fit.npz"
SCALE_TOL = 0.1  # |solved / true scale - 1| (measured 0.0014 on the card's window)


def _card_window():
    z = np.load(CARD_VI_INIT)
    pre = timu.Preintegration(**{f.name: torch.as_tensor(z[f"pre_{f.name}"])
                                 for f in dataclasses.fields(timu.Preintegration)})
    return z, pre


def _scale_ratio(t, z):
    """The map's keyframe steps over the true ones (median): 1 at metric scale."""
    n = len(z["kf_frames"])
    est = np.linalg.norm(np.diff(np.asarray(t)[:n], axis=0), axis=1)
    return float(np.median(est / np.linalg.norm(np.diff(z["gt_t"], axis=0), axis=1)))


def _cell_slam_at_vi_init():
    """The cell's MonoSLAM on the CPU holding the card run's window and IMU
    chain as they were at its first VIInit; the VI window BA that follows an
    accepted VIInit hands the window back as it is."""
    z, pre = _card_window()
    slam = program.make_slam(CONFIG, "cpu", 0)
    slam.window = slam.window.replace(R=torch.as_tensor(z["R"]), t=torch.as_tensor(z["t"]),
                                      kf_mask=torch.as_tensor(z["kf_mask"]))
    slam.imu = ImuChain(pre=pre, mask=torch.as_tensor(z["mask"]))
    slam.kf_ts = [float(x) for x in z["kf_ts"]]
    slam.n_kf = len(slam.kf_ts)
    slam._backend = lambda window, obs, imu, priors, fixed_n, lines=None: (window, obs, {})
    return slam, z


def test_card_window_link_was_dropped_by_the_gap_gate():
    z, _ = _card_window()
    gaps = np.diff(z["kf_ts"])
    n = len(gaps)
    assert list(z["mask"][:n]) == list(gaps <= 1.0) and not z["mask"][:n].all()
    assert gaps.max() > 1.0


def test_vi_init_on_the_card_window_finds_the_scale():
    """C11's regression: the JAX package's rule took a tenth of the scale."""
    slam, z = _cell_slam_at_vi_init()
    slam._run_vi_init()
    assert slam.vi_initialized
    assert abs(_scale_ratio(slam.window.t, z) - 1.0) < SCALE_TOL


def test_vi_init_refuses_a_scale_it_cannot_see():
    """Over the chain as the BA has it the solve cannot see the scale, and
    the check refuses it: VIInit waits for the next keyframe."""
    slam, _ = _cell_slam_at_vi_init()
    slam._vi_init_chain = lambda: slam.imu
    slam._run_vi_init()
    assert not slam.vi_initialized


def test_scale_information_predicts_the_cost_at_half_the_scale():
    """``scale_info`` is the solve's curvature in log s with the rest free:
    refitted with the scale held at half its solve, the cost rises by about
    a quarter of it, since the position residuals are linear in s (measured
    1.2% apart on the card's window)."""
    slam, _ = _cell_slam_at_vi_init()
    w, chain = slam.window, slam._vi_init_chain()
    res = tvi.vi_init(w.R, w.t, w.kf_mask, chain, optimize_scale=True, iters=20)
    half = tvi.vi_init(w.R, w.t * (0.5 * res["scale"]), w.kf_mask, chain, iters=20)
    rise = float(half["cost"] - res["cost"])
    assert rise == pytest.approx(float(res["scale_info"]) / 4, rel=0.05)
    assert float(res["scale_info"]) >= slam.SCALE_SEEN * float(res["cost"])


def test_gap_gated_solve_is_the_references_and_misses_the_scale():
    """Both packages' VIInit over the chain as the BA has it: the same
    scale (within 1%), a tenth of the truth or less, and |ba| inside the
    JAX package's 1 m/s^2 gate, which accepts it."""
    z, pre = _card_window()
    res_t = tvi.vi_init(torch.as_tensor(z["R"]), torch.as_tensor(z["t"]),
                        torch.as_tensor(z["kf_mask"]), ImuChain(pre=pre, mask=torch.as_tensor(
                            z["mask"])), optimize_scale=True, iters=20)
    jpre = jimu.Preintegration(**{f.name: jnp.asarray(z[f"pre_{f.name}"])
                                  for f in dataclasses.fields(jimu.Preintegration)})
    res_j = jvi.vi_init(jnp.asarray(z["R"]), jnp.asarray(z["t"]), jnp.asarray(z["kf_mask"]),
                        JImuChain(pre=jpre, mask=jnp.asarray(z["mask"])), optimize_scale=True,
                        iters=20)
    assert bool(res_t["converged"]) and bool(res_j["converged"])
    s_t, s_j = float(res_t["scale"]), float(res_j["scale"])
    assert abs(s_t / s_j - 1.0) < 0.01
    assert float(np.linalg.norm(np.asarray(res_j["ba"]))) < 1.0
    assert _scale_ratio(np.asarray(z["t"]) * s_j, z) < 0.15


def _slam_before_the_faulty_fit(monkeypatch):
    """The cell's MonoSLAM on the CPU one frame into its bootstrap, about to
    fit frame 0's features against frame 2's tracks of them, with the
    generator as it was before that fit; the tracking returns the recorded
    tracks, so no image pyramid is needed."""
    z = np.load(BOOT_FIT)
    slam = program.make_slam(CONFIG, "cpu", 0)
    slam.gen.set_state(torch.as_tensor(z["gen_state"]))
    uv0 = torch.as_tensor(z["uv0"])
    slam._boot = {"pyr0": [None], "uv0": uv0, "uv": uv0, "valid": torch.as_tensor(z["valid"]),
                  "ts0": 0.0}
    monkeypatch.setattr(mono_mod.klt, "track", lambda *a, **k: (
        torch.as_tensor(z["uv1"]), torch.as_tensor(z["ok"]), None))
    return slam


def test_faulty_bootstrap_fit_reads_ok_over_the_parallax_threshold(monkeypatch):
    slam = _slam_before_the_faulty_fit(monkeypatch)
    b = slam._boot
    _, ok, parallax, _, _, inl, ess_ok = slam._boot_track(b["pyr0"], [None], b["uv0"], b["uv"],
                                                          b["valid"])
    assert bool(ess_ok) and float(parallax) > slam.boot_parallax_deg
    assert int((ok & inl).sum()) < 0.2 * int(ok.sum())


def test_bootstrap_refuses_a_fit_few_tracks_agree_with(monkeypatch):
    """The regression: the JAX package's rule makes the first two keyframes
    from this fit."""
    slam = _slam_before_the_faulty_fit(monkeypatch)
    assert not slam._try_bootstrap(SimpleNamespace(ts=0.1), [None])
    assert not slam.initialized and slam._boot is not None


# ----------------------------------------------------------------------
# a small run: the insertion as a stage, its spans, and the plain reference
# ----------------------------------------------------------------------

SMALL_FRAMES = 17
SMALL_SEED = 2 ** 31 + 3
SMALL_MIX = {"n_points": 200, "trajectory": "default", "time_scale": 1.0, "rot_scale": 1.0,
             "imu_noise": True}
# the same inputs on both sides, float32 on the CPU, sums in the same order:
# measured 0 for the insertion and 0 for the window BA
INSERT_TOL = 1e-6
BA_TOL = 1e-5


def _small_config():
    cfg = json.loads(json.dumps(CONFIG))
    cam = cfg["cam0"]
    sx, sy = 320 / cam["resolution"][0], 240 / cam["resolution"][1]
    fx, fy, cx, cy = cam["intrinsics"]
    cam.update(resolution=[320, 240], intrinsics=[fx * sx, fy * sy, cx * sx, cy * sy])
    cfg.update(max_kf_number=4, min_lmk_number=25, max_movement_parallax=0.5)
    cfg["capacities"] = {"L": 160, "P": 24, "N_imu": 64, "pyr_levels": 3, "klt_radius": 5}
    return cfg


@pytest.fixture(scope="module")
def small_run():
    cfg = _small_config()
    world = world_mod.make_world(cfg, SMALL_MIX, SMALL_SEED, SMALL_FRAMES, "cpu")
    slam = program.make_slam(cfg, "cpu", SMALL_SEED)
    calls = {"_insert_kf": [], "_backend": []}
    found = {name: Counter() for name in calls}
    for name in calls:
        method = getattr(slam, name)

        def kept(*a, _m=method, _n=name, **k):
            inputs = bench_hooks.clone_tree((a, k))
            with _HostSyncs(found[_n]):
                out = _m(*a, **k)
            calls[_n].append((inputs, bench_hooks.clone_tree(out)))
            return out

        setattr(slam, name, kept)
    outs = [slam.process_frame(f) for f in world.frames]
    return dict(cfg=cfg, slam=slam, outs=outs, calls=calls, found=found)


def test_small_run_bootstraps_and_makes_keyframes(small_run):
    slam = small_run["slam"]
    assert slam.initialized and slam.n_resets == 0
    assert len(small_run["calls"]["_insert_kf"]) >= 3


def test_insertion_is_a_captured_stage_with_no_host_read(small_run):
    assert MonoSLAM._insert_kf.captured
    assert not small_run["found"]["_insert_kf"], dict(small_run["found"]["_insert_kf"])


def test_each_keyframe_records_its_insertion_and_landmark_counts(small_run):
    slam, calls = small_run["slam"], small_run["calls"]["_insert_kf"]
    snap = slam.trace.snapshot()
    names = np.asarray(snap["names"])[snap["spans"]["name"]]
    sp = snap["spans"]
    kf_frames = np.flatnonzero(snap["frames"]["is_kf"])[1:]  # after the bootstrap's
    per_frame = lambda name: [int((sp["frame"][names == name] == f).sum()) for f in kf_frames]
    assert per_frame("_insert_kf") == [1] * len(kf_frames) == per_frame("kf.landmarks")
    n_lmk = sp["count"][names == "kf.landmarks"]
    born = sp["count"][names == "kf.born"]
    want_lmk = [int(out[1].lmk_mask.sum()) for _, out in calls]
    want_born = [int((out[1].lmk_mask & ~a[0][2].lmk_mask).sum()) for a, out in calls]
    assert list(n_lmk) == want_lmk and list(born) == want_born
    assert sum(want_born) > 0


@pytest.fixture(scope="module")
def reference(small_run):
    cfg = small_run["cfg"]
    return ref_stages.MonoStages(ref_build.rig(cfg, "cpu"), ref_build.config(cfg),
                                 ref_build.imu_params(cfg))


@pytest.mark.parametrize("stage,gap,tol", [("_insert_kf", check.gap_insert_kf, INSERT_TOL),
                                           ("_backend", check.gap_backend, BA_TOL)])
def test_keyframe_stages_match_the_plain_reference(small_run, reference, stage, gap, tol):
    calls = small_run["calls"][stage]
    assert calls
    with torch.no_grad():
        gaps = []
        for inputs, out in calls:
            args, kwargs = check.to_ref(inputs, "cpu")
            gaps.append(gap(out, getattr(reference, stage)(*args, **kwargs)))
    assert max(gaps) <= tol, gaps
