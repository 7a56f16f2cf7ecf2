"""Host ms a tracking frame waits for its front end: the program's
``health.wait`` spans (the event wait before the health vector is read,
``pipeline/slam.py _read_health``) summed per tracking frame, mean over the
window's tracking frames."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None or win.is_kf.all():
        return None
    return float(win.ms_per_frame("health.wait")[~win.is_kf].mean())
