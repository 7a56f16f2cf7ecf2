"""Device ms of one ``_insert_kf`` call (keyframe insertion: detection,
the stereo track, triangulation), from CUDA events, mean over the window."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "_insert_kf")
