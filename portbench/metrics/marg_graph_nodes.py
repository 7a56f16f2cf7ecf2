"""Nodes of the ``_marg_roll`` graph as launched: the count on the program's
``graphs.launch`` spans under a ``_marg_roll`` span (read once per variant
at capture, ``cuGraphGetNodes``), mean per call over the window."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None:
        return None
    mask = win.named("graphs.launch", parent="_marg_roll")
    return float(win.spans["count"][mask].mean()) if mask.any() else None
