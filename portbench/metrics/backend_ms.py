"""Device ms of one ``_backend`` call (the window BA and its outlier gate,
backend/ba.py), from CUDA events, mean over the window."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "_backend")
