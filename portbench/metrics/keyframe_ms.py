"""The sum over every keyframe of the window of the time from hand-off to
pose on the host, divided by the number of keyframes, in ms."""


def read(rec):
    ms = [1e3 * t for t, kf in zip(rec["latency_s"], rec["is_kf"]) if kf]
    return sum(ms) / len(ms) if ms else None
