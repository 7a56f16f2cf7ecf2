"""Device ms of one ``_marg_roll`` call (marginalization, sparsification
and the window roll, backend/marginalization.py), from CUDA events, mean
over the window."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "_marg_roll")
