"""Host ms of one launch of the monocular keyframe insertion's graph: the
program's ``graphs.launch`` spans under an ``_insert_kf`` span, mean per
call over the window; None where the insertion launches no graph."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None:
        return None
    mask = win.named("graphs.launch", parent="_insert_kf")
    return float(win.ms(mask).mean()) if mask.any() else None
