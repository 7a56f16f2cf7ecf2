"""Shared reading of the program's own spans (not a metric).

The pipeline records its spans itself (``sadvio_tpu_torch/utils/profiler.py``,
``Recorder``): every frame is a ``frame`` span, the parent of the spans of
its work, all keyed by the frame's number.  A reader finds the recorders
of the process through ``profiler.recorders()`` and aligns one to the
measured window by the tail, with nothing else to go on:

- the traced frames come last, one ``_frontend`` call each, so their count
  is ``len(rec["live"])``;
- the window is the ``len(rec["latency_s"])`` frames just before them;
- the alignment holds only if the program's keyframe flags equal
  ``rec["is_kf"]`` frame by frame and each ``frame`` span is no longer than
  the harness's latency of that frame.

Nothing is read (``window`` returns None) when the program has no recorder
(a tree from before it), when the rings no longer hold the window, or when
no recorder aligns.
"""

from __future__ import annotations

import numpy as np

SLACK_S = 1e-6  # float rounding between the two clocks' readings of one interval
WAITS = ("health.wait", "pinned.wait")  # the frame loop's waits on the device


def recorders():
    """The program's live recorders, or [] where the program has none."""
    try:
        from sadvio_tpu_torch.utils import profiler
    except ImportError:
        return []
    find = getattr(profiler, "recorders", None)
    return list(find()) if find is not None else []


class Window:
    """The spans of the window's frames in one recorder's snapshot.
    ``is_kf``: per window frame; spans' ``frame`` counts from 0 at the
    window's first frame."""

    def __init__(self, snap, lo, hi, is_kf):
        self.n = hi - lo
        self.is_kf = np.asarray(is_kf, bool)
        sp = snap["spans"]
        keep = (sp["frame"] >= lo) & (sp["frame"] < hi) & (sp["t1"] >= 0)
        self.spans = {k: v[keep] for k, v in sp.items()}
        self.spans["frame"] = self.spans["frame"] - lo
        self.ids = {name: i for i, name in enumerate(snap["names"])}

    def named(self, name, parent=None):
        """Mask of the spans called ``name`` (under a span called ``parent``)."""
        sp = self.spans
        mask = sp["name"] == self.ids.get(name, -1)
        if parent is not None:
            at = np.searchsorted(sp["index"], sp["parent"])
            at = np.minimum(at, len(sp["index"]) - 1)
            found = sp["index"][at] == sp["parent"]
            mask &= found & (sp["name"][at] == self.ids.get(parent, -1))
        return mask

    def ms(self, mask):
        return (self.spans["t1"][mask] - self.spans["t0"][mask]) * 1e-6

    def ms_per_frame(self, name):
        """Summed ms of the spans called ``name`` in each window frame."""
        mask = self.named(name)
        return np.bincount(self.spans["frame"][mask], weights=self.ms(mask), minlength=self.n)

    def own_ms(self):
        """Per window frame: its ``frame`` span less the time its ``WAITS``
        cover (a wait inside another counts once)."""
        sp = self.spans
        frame = self.named("frame")
        own = np.zeros(self.n)
        own[sp["frame"][frame]] = self.ms(frame)
        waits = np.zeros(len(sp["frame"]), bool)
        for name in WAITS:
            waits |= self.named(name)
        for f in np.unique(sp["frame"][waits]):
            at = waits & (sp["frame"] == f)
            own[f] -= 1e-6 * covered_ns(zip(sp["t0"][at].tolist(), sp["t1"][at].tolist()))
        return own


def covered_ns(intervals):
    """The length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def align(snap, rec):
    """The ``Window`` of ``rec``'s measured window in a recorder's snapshot,
    or None where it does not align."""
    fr, sp = snap["frames"], snap["spans"]
    n_win, n_tr = len(rec["latency_s"]), len(rec.get("live") or [])
    if not n_win or not len(fr["seq"]):
        return None
    first, n = int(fr["seq"][0]), int(fr["seq"][-1]) + 1
    lo, hi = n - n_tr - n_win, n - n_tr
    if lo < first:
        return None  # the frame ring wrapped past the window
    is_kf = fr["is_kf"][lo - first:hi - first]
    if not np.array_equal(is_kf, np.asarray(rec["is_kf"], bool)):
        return None
    at = fr["span"][lo - first:hi - first] - (int(sp["index"][0]) if len(sp["index"]) else 0)
    if not len(sp["index"]) or at[0] < 0:
        return None  # the span ring wrapped past the window
    dur_s = (sp["t1"][at] - sp["t0"][at]) * 1e-9
    if (sp["t1"][at] < 0).any() or (dur_s > np.asarray(rec["latency_s"]) + SLACK_S).any():
        return None
    return Window(snap, lo, hi, is_kf)


def window(rec):
    """The window of the first live recorder that aligns with ``rec``, or None."""
    for r in recorders():
        win = align(r.snapshot(), rec)
        if win is not None:
            return win
    return None
