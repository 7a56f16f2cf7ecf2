"""Frames completed in the measured window divided by the window's seconds
(host clock; every frame ends with its pose on the host)."""


def read(rec):
    return len(rec["latency_s"]) / rec["window_s"]
