"""The port's own spans (``utils/profiler.Recorder``) over a short run.

World of tests/test_torch_slam.py cut to 14 frames (seed 3, 320x240,
bimonovio, K=4, L=160): bootstrap, tracking frames, keyframes, VIInit.  The
port runs once per module on the CPU, in the profile mode, with
``torch.profiler.record_function`` counted; two frames more run under a
``torch.profiler`` session.  The last test needs a CUDA card and skips
without one (run it there with ``--noconftest``: it imports no JAX).
"""

import json
import tracemalloc

import numpy as np
import pytest
import torch

from sadvio_tpu_torch.pipeline import synthetic
from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM
from sadvio_tpu_torch.utils import profiler

torch.set_num_threads(2)

N_FRAMES = 14
CFG = SLAMConfig(slam_mode="bimonovio", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=0.5, min_movement_parallax=0.02,
                 caps=Capacities(K=4, L=160, P=24, pyr_levels=3, klt_radius=5))
# the Profiler's names: the rows of slam_profiler.txt
PROFILED = {"imu_preint", "pyramids", "track_predict_filter", "detect_lmk_init", "window_opt",
            "frame_total", "kf_step", "track_step"}


def _world(device):
    return synthetic.make_world(seed=3, n_frames=N_FRAMES + 2, width=320, height=240,
                                n_points=200, device=device)


def _slam(world, device):
    return StereoSLAM(world.rig, CFG, imu_params=world.imu_params, device=device)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    world = _world("cpu")
    slam = _slam(world, "cpu")
    entered = []
    real = torch.profiler.record_function

    class Counted(real):
        def __init__(self, name, *a, **k):
            entered.append(name)
            super().__init__(name, *a, **k)

    torch.profiler.record_function = Counted
    try:
        slam.run(world.frames[:N_FRAMES], profile=True)
    finally:
        torch.profiler.record_function = real
    plain = slam.trace.snapshot()
    counts = dict(slam._prof.counts)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in world.frames[N_FRAMES:]:
            slam.process_frame(f)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    traced = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    return dict(slam=slam, snap=plain, counts=counts, entered=entered,
                traced=traced)


def _names(snap):
    return np.asarray(snap["names"])[snap["spans"]["name"]]


def test_every_frame_has_one_record_and_spans_nest_in_their_frame(run):
    snap, slam = run["snap"], run["slam"]
    fr, sp = snap["frames"], snap["spans"]
    names = _names(snap)
    assert list(fr["seq"]) == list(range(N_FRAMES))
    assert fr["is_kf"].sum() == len(slam.kf_traj) >= 3
    is_frame = names == "frame"
    assert list(sp["frame"][is_frame]) == list(range(N_FRAMES))  # one frame span each
    assert (sp["parent"][is_frame] == -1).all()
    assert list(fr["span"]) == list(sp["index"][is_frame])
    by_index = {int(i): k for k, i in enumerate(sp["index"])}
    assert (sp["t1"] >= sp["t0"]).all()
    for k in np.flatnonzero(~is_frame):
        p = by_index[int(sp["parent"][k])]  # every parent is a recorded span
        assert sp["frame"][k] == sp["frame"][p] >= 0  # the frame's number, shared
        assert sp["t0"][p] <= sp["t0"][k] and sp["t1"][k] <= sp["t1"][p]
    # the layer boundaries of the frame loop and the stages; a count rides
    # only a graph launch (no graph is launched on the CPU) and a keyframe's
    # landmark spans
    assert {"upload", "imu_preint", "_preint", "_pyramids", "_frontend", "kf.wait",
            "_insert_kf", "_backend", "vi_init", "kf.landmarks", "kf.born"} <= set(names)
    counted = np.isin(names, ["kf.landmarks", "kf.born"])
    assert (sp["count"][~counted] == 0).all()
    assert (sp["count"][names == "kf.landmarks"] > 0).all()


def test_profile_mode_fills_the_profiler_under_its_old_names(run):
    counts = run["counts"]
    assert set(counts) == PROFILED
    assert counts["frame_total"] == N_FRAMES
    assert counts["kf_step"] + counts["track_step"] == N_FRAMES
    assert counts["kf_step"] == run["snap"]["frames"]["is_kf"].sum()
    assert all(run["slam"]._prof.sums[n] > 0 for n in PROFILED)


def test_no_profiler_range_without_a_profiler_and_the_names_under_one(run):
    assert run["entered"] == []
    assert {"frame", "imu_preint", "pyramids", "_pyramids", "track_predict_filter",
            "_frontend", "upload"} <= run["traced"]


def test_the_rings_wrap_in_place_without_allocating():
    rec = profiler.Recorder(frames=8, spans=32)
    arrays = [rec.frame_ts, rec.span_t0, rec.span_t1, rec.span_parent]
    addresses = [a.ctypes.data for a in arrays]
    for k in range(3):  # the first frames intern their names
        with rec.frame(float(k)):
            with rec.span("a"):
                with rec.span("b", 7):
                    pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for k in range(3, 1000):
            with rec.frame(float(k)):
                with rec.span("a"):
                    with rec.span("b", k):
                        pass
                rec.end_frame(k % 5 == 0)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024, grown
    assert [a.ctypes.data for a in arrays] == addresses
    assert rec.n_frames == 1000 and rec.n_spans == 3000
    snap = rec.snapshot()
    assert list(snap["frames"]["seq"]) == list(range(992, 1000))
    assert list(snap["frames"]["ts"]) == [float(k) for k in range(992, 1000)]
    assert list(snap["frames"]["is_kf"]) == [k % 5 == 0 for k in range(992, 1000)]
    sp = snap["spans"]
    assert list(sp["index"]) == list(range(2968, 3000))
    names = _names(snap)
    b = names == "b"
    assert list(sp["count"][b]) == list(sp["frame"][b])
    assert (sp["parent"][b] == sp["index"][b] - 1).all()


def test_card_graph_spans_and_frontend_kernels_under_its_range():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stages replay as CUDA graphs only there")
    from portbench import trace as trace_mod

    dev = torch.device("cuda")
    world = _world(dev)
    slam = _slam(world, dev)
    for f in world.frames[:N_FRAMES]:
        slam.process_frame(f)
    snap = slam.trace.snapshot()
    sp, names = snap["spans"], _names(snap)
    launch = names == "graphs.launch"
    assert launch.any()
    assert (sp["count"][launch] > 0).all()  # the graphs' node counts
    assert (sp["count"][~launch] == 0).all()
    assert {"health.wait", "pinned.wait"} <= set(names)
    parents = dict(zip(sp["index"].tolist(), names.tolist()))
    assert {parents[int(p)] for p in sp["parent"][launch]} >= {"_frontend", "_preint"}
    prof = trace_mod.profiler()
    prof.start()
    for f in world.frames[N_FRAMES:]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    prof.stop()
    kernels = trace_mod.reduce(prof)["kernels"]
    lk = [v for k, v in kernels.items() if "lk_track" in k]
    assert lk and set().union(*lk) <= {"_frontend", "_insert_kf"}, lk
    assert sum(v.get("_frontend", [0])[0] for v in lk) == 2  # one frame track per frame
