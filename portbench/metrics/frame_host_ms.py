"""Host ms of a tracking frame's own work: the program's ``frame`` span less
the time its wait spans (``health.wait``, ``pinned.wait``) cover, mean over
the window's tracking frames."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None or win.is_kf.all():
        return None
    return float(win.own_ms()[~win.is_kf].mean())
