"""``lk_track``'s share of its roofline in the frame track, in %: the least
time the card could take for the traced frames' launches
(``bounds.lk_track_s`` over the live slots that ``_frontend`` was handed,
``tracks.valid[0]``), divided by the launches' device time from the
profiler's trace of the frames after the window.  Only the launches issued
by ``_frontend`` count; nothing is read when they cannot be told apart or
their count differs from the calls'."""

from portbench import bounds


def read(rec):
    trace = rec.get("trace")
    if not trace:
        return None
    caps = rec["config"]["capacities"]
    launches = [v.get("_frontend") for k, v in trace["kernels"].items() if "lk_track" in k]
    launches = [x for x in launches if x]
    live = rec["live"]
    if len(launches) != 1 or launches[0][0] != len(live) or launches[0][1] <= 0:
        return None
    need = sum(bounds.lk_track_s(n, caps["L"], shape, caps["pyr_levels"], caps["klt_radius"])
               for n, shape in live)
    return 100.0 * need / launches[0][1]
