"""Host ms per frame inside ``CUDAGraph.replay()``: the program's
``graphs.launch`` spans (``utils/graphs.py``) summed per frame, mean over the
window's frames."""

from portbench.metrics._program import window


def read(rec):
    win = window(rec)
    return None if win is None else float(win.ms_per_frame("graphs.launch").mean())
