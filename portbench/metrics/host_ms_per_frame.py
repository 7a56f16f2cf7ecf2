"""Host ms per frame in the captured stages' replays (copies in, graph
launch, clones out), from the program's ``graphs.stats()`` counters: the
window's ``replay_s`` summed over the stages, divided by its frames."""


def read(rec):
    return 1e3 * rec["replay_s"] / len(rec["latency_s"])
