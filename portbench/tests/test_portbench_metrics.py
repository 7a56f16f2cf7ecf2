"""The end-to-end and per-layer arithmetic on made-up timings."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import bounds, cells


def rec(latency_ms, is_kf, window_s=None, **kw):
    lat = [x / 1e3 for x in latency_ms]
    return {"latency_s": lat, "is_kf": is_kf,
            "window_s": sum(lat) if window_s is None else window_s, **kw}


def test_rate_is_every_frame_over_the_whole_window():
    r = rec([10.0] * 90 + [200.0] * 10, [False] * 90 + [True] * 10)
    assert cells.reader("frames_per_s")(r) == pytest.approx(100 / 2.9)
    r["window_s"] = 4.0  # time in the window outside the frames counts too
    assert cells.reader("frames_per_s")(r) == pytest.approx(25.0)


def test_tracking_mean_is_over_every_tracking_frame_and_one_stall_moves_it():
    lat = list(np.linspace(5.0, 15.0, 200))
    kf = [False] * 200
    read = cells.reader("track_ms_mean")
    base = read(rec(lat + [500.0], kf + [True]))  # keyframes are not tracking frames
    assert base == pytest.approx(10.0)
    stalled = lat[:]
    stalled[7] += 200.0  # one frame 200 ms late
    assert read(rec(stalled, kf)) == pytest.approx(base + 200.0 / 200)
    assert read(rec([100.0], [True])) is None


def test_keyframe_time_is_the_sum_over_keyframes_per_keyframe():
    read = cells.reader("keyframe_ms")
    r = rec([8.0] * 50 + [100.0, 120.0, 140.0], [False] * 50 + [True] * 3)
    assert read(r) == pytest.approx(120.0)
    r = rec([8.0] * 50 + [100.0, 120.0, 1400.0], [False] * 50 + [True] * 3)
    assert read(r) == pytest.approx(540.0)  # one stalled keyframe moves the mean
    assert read(rec([8.0] * 5, [False] * 5)) is None


def test_counter_and_span_readers():
    r = rec([10.0] * 8, [False, True] * 4, replay_s=0.004)
    assert cells.reader("kf_per_100_frames")(r) == pytest.approx(50.0)
    assert cells.reader("host_ms_per_frame")(r) == pytest.approx(0.5)
    r["spans"] = {"_pyramids": [(0, 1.0), (2, 1.0), (1, 9.0)],
                  "_frontend": [(0, 3.0), (2, 5.0), (1, 9.0)],
                  "_backend": [(1, 20.0), (3, 30.0)]}
    assert cells.reader("frontend_ms")(r) == pytest.approx(5.0)  # frames 0 and 2 only
    assert cells.reader("backend_ms")(r) == pytest.approx(25.0)
    assert cells.reader("marg_roll_ms")(r) is None


def test_lk_track_roofline_from_the_frontend_launches_only():
    cfg = {"capacities": {"L": 512, "pyr_levels": 3, "klt_radius": 7}}
    live = [(300, (480, 752)), (310, (480, 752))]
    need = sum(bounds.lk_track_s(n, 512, s, 3, 7) for n, s in live)
    trace = {"kernels": {"lk_track_kernel(float const*)": {"_frontend": [2, need * 4],
                                                           "_insert_kf": [1, 1.0]}}}
    read = cells.reader("lk_track_roofline")
    assert read({"trace": trace, "live": live, "config": cfg}) == pytest.approx(25.0)
    assert read({"trace": trace, "live": live[:1], "config": cfg}) is None  # counts differ
    assert read({"trace": None, "live": live, "config": cfg}) is None


def test_lk_track_bound_grows_with_live_slots_and_is_bytes():
    small = bounds.lk_track_s(10, 512, (480, 752), 3, 7)
    big = bounds.lk_track_s(400, 512, (480, 752), 3, 7)
    assert 0 < small < big
    assert bounds.lk_track_s(0, 512, (480, 752), 3, 7) > 0  # the slot inputs are read
    # the bytes alone: the live slots' windows at every level, the slot inputs and outputs
    S = 15
    windows = 400 * 3 * ((S + 2) ** 2 + (S + 1) ** 2) * 4
    io = 512 * (2 * 8 + 1 + 16) + 512 * (2 * 4 + 1 + 4)
    assert big == pytest.approx((windows + io) / bounds.PEAK_BYTES_S)
