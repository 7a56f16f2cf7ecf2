"""Keyframes per 100 frames of the window (``out["is_kf"]`` of
``process_frame``): the keyframe vote's share of the frames."""


def read(rec):
    return 100.0 * sum(rec["is_kf"]) / len(rec["is_kf"])
