"""Landmarks born at a keyframe: the count on the program's ``kf.born``
spans, each under the keyframe's ``kf.landmarks`` span (whose own count is
the window's landmarks after the insertion; both ride the keyframe's one
state copy, ``pipeline/slam.py``), mean per keyframe over the window.  A
monocular landmark is born only when a later keyframe gives its track a
baseline.  None where the program records no such span."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None:
        return None
    mask = win.named("kf.born", parent="kf.landmarks")
    return float(win.spans["count"][mask].mean()) if mask.any() else None
