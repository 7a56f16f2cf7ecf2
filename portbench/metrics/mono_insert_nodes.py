"""Nodes of the monocular keyframe insertion's graph as launched: the count
on the program's ``graphs.launch`` spans under an ``_insert_kf`` span (read
once per variant at capture, ``cuGraphGetNodes``), mean per call over the
window.  A program that runs the insertion eagerly launches no graph there,
and the reader returns None."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None:
        return None
    mask = win.named("graphs.launch", parent="_insert_kf")
    return float(win.spans["count"][mask].mean()) if mask.any() else None
