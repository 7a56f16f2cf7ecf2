"""Host ms a keyframe waits for its state: the program's ``kf.wait`` span
(the keyframe's one state read, ``pipeline/slam.py``) summed per keyframe,
mean over the window's keyframes.  The host reads nothing between launching
``_marg_roll`` and that read, so the wait holds the device work of
``_marg_roll``, ``_insert_kf`` and ``_backend`` together."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    if win is None or not win.is_kf.any():
        return None
    return float(win.ms_per_frame("kf.wait")[win.is_kf].mean())
