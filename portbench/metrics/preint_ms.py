"""Device ms of one ``_preint`` call (one 32-row IMU batch preintegrated,
models/imu.py), from CUDA events around each call, mean over the window."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "_preint")
