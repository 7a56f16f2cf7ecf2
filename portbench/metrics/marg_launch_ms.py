"""Host ms of one launch of the ``_marg_roll`` graph: the program's
``graphs.launch`` spans under a ``_marg_roll`` span, mean per call over the
window."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None:
        return None
    mask = win.named("graphs.launch", parent="_marg_roll")
    return float(win.ms(mask).mean()) if mask.any() else None
