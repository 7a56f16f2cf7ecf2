"""The readers of the program's own spans (``metrics/_program.py`` and the
six metrics on it) on made-up frame records: the window found by the tail,
and nothing read where the records do not align or no longer hold it."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import cells
from portbench.metrics import _program

NEW = ("health_wait_ms", "frame_host_ms", "graph_launch_ms", "marg_launch_ms",
       "marg_graph_nodes", "kf_wait_ms")
MS = 1_000_000  # ns


def tracking(ms, wait=0.0, launch=0.0):
    """A tracking frame of ``ms``: a health wait and a pinned wait, and a
    ``_frontend`` replay whose launch takes ``launch``."""
    return (False, ms, [("health.wait", "frame", 1.0, 1.0 + wait, 0),
                        ("pinned.wait", "frame", 0.2, 0.5, 0),
                        ("_frontend", "frame", 0.1, 0.9, 0),
                        ("graphs.launch", "_frontend", 0.3, 0.3 + launch, 20)])


def keyframe(ms, wait, launch, nodes):
    """A keyframe of ``ms``: a ``_marg_roll`` replay and the state read."""
    return (True, ms, [("_marg_roll", "frame", 0.1, 0.1 + launch + 1.0, 0),
                       ("graphs.launch", "_marg_roll", 0.5, 0.5 + launch, nodes),
                       ("kf.wait", "frame", 2.0 + launch, 2.0 + launch + wait, 0)])


def snapshot(frames, first_frame=0, first_span=0):
    """A recorder's snapshot of ``frames`` (is_kf, frame ms, spans named
    under a parent of the same frame, ms from the frame's start), dropping
    the records before ``first_frame`` and ``first_span``, as a wrap does."""
    names, fr, sp = [], [], []
    nid = lambda n: names.index(n) if n in names else (names.append(n) or len(names) - 1)
    for seq, (kf, ms, spans) in enumerate(frames):
        t = seq * 1000 * MS
        at = {"frame": len(sp)}
        fr.append((seq, float(seq), kf, len(sp)))
        sp.append((len(sp), seq, nid("frame"), -1, t, t + int(ms * MS), 0))
        for name, parent, a, b, count in spans:
            at[name] = len(sp)
            sp.append((len(sp), seq, nid(name), at[parent], t + int(a * MS), t + int(b * MS),
                       count))
    fr = [x for x in fr if x[0] >= first_frame]
    sp = [x for x in sp if x[0] >= first_span]
    cols = lambda rows, keys: {k: np.asarray([r[i] for r in rows]) for i, k in enumerate(keys)}
    return {"frames": cols(fr, ("seq", "ts", "is_kf", "span")),
            "spans": cols(sp, ("index", "frame", "name", "parent", "t0", "t1", "count")),
            "names": names}


class Fake:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return self.snap


# warm-up, then the window (tracking 8 ms, keyframe 130 ms), then two traced
# frames; warm-up and traced frames carry values that would show if read
WARM = [tracking(50.0, wait=40.0, launch=30.0), keyframe(900.0, 500.0, 300.0, 1)]
WINDOW = [tracking(8.0, wait=4.0, launch=0.5), tracking(8.0, wait=5.0, launch=0.7),
          keyframe(130.0, 30.0, 20.0, 47000), tracking(9.0, wait=5.0, launch=0.6),
          keyframe(140.0, 40.0, 22.0, 48000)]
TRACED = [tracking(60.0, wait=50.0, launch=40.0), tracking(60.0, wait=50.0, launch=40.0)]


def rec_of(window):
    return {"latency_s": [ms / 1e3 + 1e-4 for _, ms, _ in window],
            "is_kf": [kf for kf, _, _ in window], "live": [(100, (480, 752))] * len(TRACED)}


@pytest.fixture
def records(monkeypatch):
    found = []
    monkeypatch.setattr(_program, "recorders", lambda: found)
    return found


def read_all(rec):
    return {name: cells.reader(name)(rec) for name in NEW}


def test_the_window_is_found_by_the_tail(records):
    records.append(Fake(snapshot(WARM + WINDOW + TRACED)))
    got = read_all(rec_of(WINDOW))
    assert got["health_wait_ms"] == pytest.approx((4 + 5 + 5) / 3)
    # a tracking frame less its two waits: 8 - 4 - 0.3, 8 - 5 - 0.3, 9 - 5 - 0.3
    assert got["frame_host_ms"] == pytest.approx((3.7 + 2.7 + 3.7) / 3)
    assert got["graph_launch_ms"] == pytest.approx((0.5 + 0.7 + 20 + 0.6 + 22) / 5)
    assert got["marg_launch_ms"] == pytest.approx(21.0)
    assert got["marg_graph_nodes"] == pytest.approx(47500)
    assert got["kf_wait_ms"] == pytest.approx(35.0)


def test_the_waits_a_frame_covers_count_once(records):
    # a pinned wait inside the health wait: the covered time is the longer one
    frame = (False, 8.0, [("health.wait", "frame", 1.0, 5.0, 0),
                          ("pinned.wait", "health.wait", 2.0, 3.0, 0)])
    rec = rec_of([frame])
    rec["live"] = []
    win = _program.align(snapshot([frame]), rec)
    assert win is not None and win.n == 1
    assert win.named("pinned.wait", parent="health.wait").sum() == 1
    assert not win.named("pinned.wait", parent="frame").any()
    records.append(Fake(snapshot([frame])))
    assert cells.reader("frame_host_ms")(rec) == pytest.approx(4.0)


def test_nothing_is_read_when_the_keyframe_flags_disagree(records):
    records.append(Fake(snapshot(WARM + WINDOW + TRACED)))
    rec = rec_of(WINDOW)
    rec["is_kf"][1] = True
    assert set(read_all(rec).values()) == {None}
    rec = rec_of(WINDOW)
    rec["live"] = rec["live"][:1]  # one traced frame too few: the window shifts by one
    assert set(read_all(rec).values()) == {None}


def test_nothing_is_read_when_a_frame_outlasts_its_latency(records):
    records.append(Fake(snapshot(WARM + WINDOW + TRACED)))
    rec = rec_of(WINDOW)
    rec["latency_s"][2] = 0.100  # the keyframe's span is 130 ms
    assert set(read_all(rec).values()) == {None}


def test_nothing_is_read_when_the_rings_wrapped_past_the_window(records):
    frames = WARM + WINDOW + TRACED
    records.append(Fake(snapshot(frames, first_frame=len(WARM) + 1)))
    assert set(read_all(rec_of(WINDOW)).values()) == {None}
    records[:] = [Fake(snapshot(frames, first_span=len(WARM[0][2]) + len(WARM[1][2]) + 3))]
    assert set(read_all(rec_of(WINDOW)).values()) == {None}
    # the rings still hold the window: read
    records[:] = [Fake(snapshot(frames, first_frame=len(WARM),
                                first_span=len(WARM[0][2]) + len(WARM[1][2]) + 2))]
    assert read_all(rec_of(WINDOW))["kf_wait_ms"] == pytest.approx(35.0)


def test_the_first_aligned_recorder_is_read_and_none_without_one(records):
    assert set(read_all(rec_of(WINDOW)).values()) == {None}
    records.append(Fake(snapshot(WINDOW[:3])))  # another pipeline's records
    records.append(Fake(snapshot(WARM + WINDOW + TRACED)))
    assert read_all(rec_of(WINDOW))["marg_graph_nodes"] == pytest.approx(47500)


def test_a_program_without_recorders_reads_nothing(monkeypatch):
    from sadvio_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "recorders")
    assert _program.recorders() == []
    assert set(read_all(rec_of(WINDOW)).values()) == {None}
