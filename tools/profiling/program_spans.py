"""The program's own spans over one traced run of a benchmark cell: the
measured window against the traced frames after it, each frame class split
into a fast and a slow class.

    python3 tools/profiling/program_spans.py --workload stereo_vio.replay \
        --seed 7 --seconds 50 [--out spans.json]

On a CUDA card, from the root of a checkout.  The cell runs as
``python3 -m portbench.run ... --trace 1`` runs it; the pipeline's recorder
(``sadvio_tpu_torch/utils/profiler.py``) is kept, aligned to the window as
the benchmark's readers align it (``portbench/metrics/_program.py``), and
read per group of frames: ``window`` and ``traced``; ``track`` and ``kf``;
``fast`` and ``slow`` (a tracking frame's ``frame`` span against
``--track-split-ms``, a keyframe's against ``--kf-split-ms``).  Per group:
the frame count, the spans per frame, and each span's host ms per frame
(a graph launch keyed by its stage, as ``graphs.launch@_marg_roll``),
``own`` (the frame less its waits, as ``frame_host_ms`` reads it) and the
node count of each stage's launch.  Prints one JSON line with the groups,
the result's metrics and idle gaps; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

def table(win, frames):
    """Host ms per frame of each span over the window frames ``frames`` (a
    boolean mask), a graph launch keyed by its stage."""
    sp, names = win.spans, {i: n for n, i in win.ids.items()}
    n = int(frames.sum())
    if not n:
        return {"frames": 0}
    pos = {int(i): k for k, i in enumerate(sp["index"])}
    keys = []
    for k in range(len(sp["index"])):
        name = names[int(sp["name"][k])]
        if name.startswith("graphs."):
            p = pos.get(int(sp["parent"][k]))
            name = f"{name}@{names[int(sp['name'][p])] if p is not None else '?'}"
        keys.append(name)
    keys = np.asarray(keys)
    in_group = frames[sp["frame"]]
    dur = (sp["t1"] - sp["t0"]) * 1e-6
    out = {"frames": n, "spans": float(in_group.sum() / n),
           "own": float(win.own_ms()[frames].mean())}
    for key in sorted(set(keys[in_group])):
        at = in_group & (keys == key)
        out[key] = float(dur[at].sum() / n)
        if key.startswith("graphs.launch@"):
            out[key.replace("graphs.launch", "nodes")] = float(sp["count"][at].mean())
            out[key.replace("graphs.launch", "calls")] = int(at.sum())
    return out


def groups(win, track_split_ms, kf_split_ms):
    frame = win.named("frame")
    ms = np.zeros(win.n)
    ms[win.spans["frame"][frame]] = win.ms(frame)
    out = {}
    for kind, mask, split in (("track", ~win.is_kf, track_split_ms), ("kf", win.is_kf,
                                                                       kf_split_ms)):
        out[kind] = table(win, mask)
        out[f"{kind}.fast"] = table(win, mask & (ms <= split))
        out[f"{kind}.slow"] = table(win, mask & (ms > split))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="stereo_vio.replay")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--track-split-ms", type=float, default=8.7)
    ap.add_argument("--kf-split-ms", type=float, default=142.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import cells, run as run_mod
    from portbench.metrics import _program
    from sadvio_tpu_torch.utils import profiler

    run_mod._set_environment()
    import torch

    torch.set_num_threads(1)
    kept, seen = [], {}
    init = profiler.Recorder.__init__

    def keep(self, *a, **k):  # the run frees its pipeline; its recorder stays here
        init(self, *a, **k)
        kept.append(self)

    profiler.Recorder.__init__ = keep
    reader = cells.reader

    def reading(name, root=cells.ROOT):
        read = reader(name, root)

        def wrapped(rec):
            seen.setdefault("rec", rec)
            return read(rec)

        return wrapped

    cells.reader = reading
    result = run_mod.run(cells.load(args.workload), args.seed, args.seconds, True, "cuda")
    rec = seen["rec"]
    out = {"seed": args.seed, "device": result["device"]["kind"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "idle_gaps": result.get("breakdown", {}).get("idle_gaps"),
           "busy_s": result["device"].get("busy_s"), "window_s": result["device"].get("window_s"),
           "latency_ms": {"track": float(np.mean([x for x, k in zip(rec["latency_s"],
                                                                       rec["is_kf"]) if not k]))
                          * 1e3},
           "correct": result["correct"]}
    for r in kept:
        snap = r.snapshot()
        win = _program.align(snap, rec)
        if win is None:
            continue
        n_tr = len(rec["live"])
        n = int(snap["frames"]["seq"][-1]) + 1
        tail = snap["frames"]["is_kf"][len(snap["frames"]["seq"]) - n_tr:]
        traced = _program.Window(snap, n - n_tr, n, tail)
        out["window"] = groups(win, args.track_split_ms, args.kf_split_ms)
        out["traced"] = groups(traced, args.track_split_ms, args.kf_split_ms)
        break
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
