"""Shared arithmetic of the span readers (not a metric)."""


def mean_ms(rec, stage):
    ms = [m for _, m in rec["spans"].get(stage, [])]
    return sum(ms) / len(ms) if ms else None


def per_tracking_frame_ms(rec, stages):
    """Mean over the window's tracking frames of the summed device ms of
    ``stages`` in that frame."""
    tracking = {i for i, kf in enumerate(rec["is_kf"]) if not kf}
    total = {}
    for stage in stages:
        for frame, ms in rec["spans"].get(stage, []):
            if frame in tracking:
                total[frame] = total.get(frame, 0.0) + ms
    return sum(total.values()) / len(total) if total else None
