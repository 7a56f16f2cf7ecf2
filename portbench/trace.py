"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the first frames of the measured window, exported as a Chrome trace into a
temporary directory and reduced there.

- busy seconds: the union of the intervals in which a kernel, a copy or a
  set ran on the device, within the traced window;
- device ops: device seconds summed by kernel name;
- idle gaps: the device's gaps, each named by what the host was doing when
  it began (the innermost stage range, ``frame`` when the host was in the
  frame loop outside any stage, ``host`` outside ``process_frame``);
- per kernel name and stage: device seconds and launches, the stage found
  through the correlation of each kernel with the graph launch (or the
  launch call) that issued it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges, starts, t):
    """The name of the innermost range (start, end, name) holding time t."""
    best = None
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(ranges[max(0, i - 64):i]):
        if a <= t < b and (best is None or a > best[0]):
            best = (a, name)
    return None if best is None else best[1]


WINDOW = "portbench.window"  # the range the harness puts around the traced frames


def reduce(prof) -> dict:
    """Reduce a finished profiler session over the ``WINDOW`` range (or, if
    the trace lacks it, the span of its device activity)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev, ranges, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], cat, (e.get("args") or {}).get("correlation")))
        elif cat == "user_annotation":
            ranges.append((ts, ts + dur, e["name"]))
        elif cat == "cuda_runtime":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": [],
                "kernels": {}}
    win = [r for r in ranges if r[2] == WINDOW]
    ranges = sorted(r for r in ranges if r[2] != WINDOW)
    starts = [r[0] for r in ranges]
    lo, hi = (win[0][0], win[0][1]) if win else (min(d[0] for d in dev), max(d[1] for d in dev))
    busy = _merge([(max(a, lo), min(b, hi)) for a, b, *_ in dev if b > lo and a < hi])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    by_name, kernels = {}, {}
    for a, b, name, cat, corr in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if cat != "kernel":
            continue
        t_launch = launches.get(corr)
        stage = None if t_launch is None else _innermost(ranges, starts, t_launch)
        k = kernels.setdefault(name, {})
        s = k.setdefault(stage or "host", [0, 0.0])
        s[0] += 1
        s[1] += (b - a) * 1e-6

    gaps = []
    edges = [[lo, lo]] + busy + [[hi, hi]]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            gaps.append((_innermost(ranges, starts, a) or "host", (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": (hi - lo) * 1e-6,
            "device_ops": [[n[:64], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in gaps[:TOP]], "kernels": kernels}
