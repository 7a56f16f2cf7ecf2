"""Device ms of the front end per tracking frame: ``_pyramids`` and
``_frontend`` (KLT track, PnP RANSAC, epipolar gate, ESKF), from CUDA events
around each call, summed per frame and averaged over the window's tracking
frames."""

from portbench.metrics._spans import per_tracking_frame_ms


def read(rec):
    return per_tracking_frame_ms(rec, ("_pyramids", "_frontend"))
