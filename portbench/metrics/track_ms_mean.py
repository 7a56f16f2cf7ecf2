"""Mean, over every tracking (non-keyframe) frame of the window, of the time
from hand-off to pose on the host, in ms: the sum of their times over their
count."""


def read(rec):
    ms = [1e3 * t for t, kf in zip(rec["latency_s"], rec["is_kf"]) if not kf]
    return sum(ms) / len(ms) if ms else None
