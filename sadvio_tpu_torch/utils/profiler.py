"""Stage profiler and span recorder.

``Profiler``, a port of ``sadvio_tpu/utils/profiler.py``: a tic/toc stack,
running averages and the profiler dump.  Work on the card is queued, so a
stage is timed by waiting for its output: ``toc(name, block=tensor)`` calls
``torch.cuda.synchronize()`` when ``tensor`` lies on a CUDA device, and
nothing more on the CPU, where every op has finished when it returns.
This holds for the profile mode (``run(profile=True)``) only: waiting at
every stage serializes the frame loop.

``Recorder``: the spans of one pipeline, always on.  A span has the frame it
belongs to (a per-pipeline count of ``process_frame`` calls), a name, its
parent span, its start and end from ``time.perf_counter_ns()`` and one
integer count (a graph launch's nodes); a frame record adds the
frame's stamp and whether it became a keyframe.  Records go into
preallocated numpy rings that wrap around; a span costs two clock reads and
a few ring writes, with no device synchronisation, no CUDA event and no
device allocation.  While a ``torch.profiler`` session is active a span also
enters ``torch.profiler.record_function(name)``, so the program's spans land
in the device trace on its clock.  In the profile mode a span opened with
``timed=True`` waits for the tensor given to ``wait`` and adds its time to
the ``Profiler`` under its own name, as ``toc`` does.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_LIVE = weakref.WeakSet()  # every Recorder of the process


def wait_for(x):
    """Block until the work that produces the tensor ``x`` has finished."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class Profiler:
    def __init__(self):
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self._stack = []

    def tic(self):
        self._stack.append(time.perf_counter())

    def toc(self, name, block=None):
        if block is not None:
            wait_for(block)
        dt = time.perf_counter() - self._stack.pop()
        self.add(name, dt)
        return dt

    def add(self, name, dt):
        self.sums[name] += dt
        self.counts[name] += 1

    @contextmanager
    def stage(self, name):
        self.tic()
        out = {}
        try:
            yield out
        finally:
            self.toc(name, block=out.get("block"))

    def avg_ms(self, name):
        c = self.counts[name]
        return 1000.0 * self.sums[name] / c if c else 0.0

    def dump(self, path=None):
        """Raw stage table (every recorded stage)."""
        lines = ["stage                          avg_ms      calls     total_s"]
        for name in sorted(self.sums):
            lines.append(f"{name:<28} {self.avg_ms(name):>9.3f} {self.counts[name]:>10d}"
                         f" {self.sums[name]:>11.3f}")
        text = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def dump_slam(self, path=None, *, n_frames=0, n_keyframes=0, pose_estimator="pnp",
                  mesh_on=False):
        """slam_profiler.txt: the reference's field set mapped onto the
        pipeline's stages (the rows of the JAX package's dump), followed by
        the raw stage table.  Rows that the pipeline computes in one stage
        print that stage's time and name it."""
        am = self.avg_ms
        kf_over_frames = n_keyframes / max(n_frames, 1)
        front = (am("pyramids") + am("imu_preint") + am("track_predict_filter")
                 + (am("detect_lmk_init") + am("line_channel")) * kf_over_frames)
        back = (am("window_opt") + am("marginalization") + am("nfr_edge")) * kf_over_frames
        tpf = f"{am('track_predict_filter'):.3f} (=track_predict_filter)"
        dli = f"{am('detect_lmk_init'):.3f} (=detect_lmk_init)"
        rows = [
            "===== SLAM profiler =======",
            str(int(time.time())),
            f"Number of frames: {n_frames}",
            f"Number of keyframes: {n_keyframes}",
            f"Img process dt: {am('pyramids'):.3f}",
            f"Detection dt: {dli}",
            f"Prediction {pose_estimator}RANSAC dt: {tpf}",
            f"Matching in frame dt: {dli}",
            f"Matching in time dt: {tpf}",
            f"Average filter time dt: {tpf}",
            f"Average cleaning time dt: {am('window_opt'):.3f} (=window_opt)",
            f"Landmark init dt: {dli}",
            f"Optimize frame dt: {tpf}",
            f"Marginalization dt: {am('marginalization'):.3f}",
        ]
        if mesh_on:
            rows.append(f"Mesh dt: {am('mesh'):.3f}")
        rows += [
            f"Optimize window dt: {am('window_opt'):.3f}",
            f"Front end dt: {front:.3f}",
            f"Back end dt: {back:.3f}",
            "",
        ]
        text = "\n".join(rows) + self.dump()
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


def recorders():
    """The live recorders of this process (one per pipeline instance)."""
    return list(_LIVE)


class _Frame:
    """The context of one frame: closes its span and its record."""

    __slots__ = ("rec",)

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        return self.rec

    def __exit__(self, *exc):
        self.rec._end_frame()
        return False


class Recorder:
    """Frame-keyed spans and counts of one pipeline in rings of ``frames``
    frame records and ``spans`` span records (powers of two).

    ``with rec.frame(ts): ...`` opens a frame and its ``frame`` span;
    ``with rec.span(name, count): ...`` a span inside the innermost open
    one.  Span and frame indices are absolute (they keep counting past a
    wrap): the record of index ``i`` sits at ``i % capacity`` until it is
    overwritten.

    ``annotate=False``: the span enters no profiler range, so the device
    work it launches stays under its parent's range in a trace.  Whether a
    ``torch.profiler`` session is active is read once per frame (and at
    every span outside a frame): a session started inside a frame shows
    from the next one.

    ``prof``: the ``Profiler`` the timed spans feed (the profile mode), or
    None; ``frame(ts, prof)`` names the one its frame's own time feeds."""

    MAX_DEPTH = 64

    def __init__(self, frames: int = 1 << 14, spans: int = 1 << 19):
        for n in (frames, spans):
            if n <= 0 or n & (n - 1):
                raise ValueError(f"ring sizes are powers of two, not {n}")
        self.frame_ts = np.zeros(frames, np.float64)
        self.frame_kf = np.zeros(frames, np.int8)
        self.frame_span = np.zeros(frames, np.int64)
        self.span_frame = np.zeros(spans, np.int64)
        self.span_name = np.zeros(spans, np.int32)
        self.span_parent = np.zeros(spans, np.int64)
        self.span_t0 = np.zeros(spans, np.int64)
        self.span_t1 = np.zeros(spans, np.int64)
        self.span_count = np.zeros(spans, np.int64)
        # element writes through memoryviews: no numpy scalar per write
        self._fts, self._fkf, self._fspan = (memoryview(a) for a in (
            self.frame_ts, self.frame_kf, self.frame_span))
        self._sframe, self._sname, self._sparent, self._st0, self._st1, self._scount = (
            memoryview(a) for a in (self.span_frame, self.span_name, self.span_parent,
                                    self.span_t0, self.span_t1, self.span_count))
        self._fmask, self._smask = frames - 1, spans - 1
        self.n_frames = 0  # frames begun (the next frame's number)
        self.n_spans = 0  # spans begun (the next span's index)
        self.names = []  # name id -> name
        self._ids = {}
        self._cur = -1  # the open frame's number, -1 outside a frame
        self._annot = None  # a profiler session is active (read at the frame), None outside
        # per depth (1 = outermost; slot 0 is the root's -1): the open
        # spans' indices, profiler ranges, profiler names and the tensors
        # they wait for (the last two in the profile mode)
        self._depth = 0
        self._stack = [-1] + [0] * self.MAX_DEPTH
        self._ranges = [None] * (self.MAX_DEPTH + 1)
        self._timed = [None] * (self.MAX_DEPTH + 1)
        self._block = [None] * (self.MAX_DEPTH + 1)
        self._frame_cm = _Frame(self)
        self._frame_prof = None
        self._frame_block = None
        self.prof = None
        _LIVE.add(self)

    def _intern(self, name):
        i = self._ids[name] = len(self.names)
        self.names.append(name)
        return i

    def span(self, name, count=0, timed=False, annotate=True):
        """Open the span ``name`` (with ``count``) inside the innermost open
        one; the recorder is its context: ``with rec.span(name): ...``."""
        i = self.n_spans
        self.n_spans = i + 1
        j = i & self._smask
        d = self._depth
        nid = self._ids.get(name)
        self._sframe[j] = self._cur
        self._sname[j] = self._intern(name) if nid is None else nid
        self._sparent[j] = self._stack[d]
        self._scount[j] = count
        d += 1
        self._stack[d] = i
        self._depth = d
        if timed and self.prof is not None:
            self._timed[d] = name
        if annotate and (_profiling() if self._annot is None else self._annot):
            r = torch.profiler.record_function(name)
            r.__enter__()
            self._ranges[d] = r
        self._st0[j] = _now()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t = _now()
        d = self._depth
        j = self._stack[d] & self._smask
        name = self._timed[d]
        if name is not None:
            self._timed[d] = None
            block, self._block[d] = self._block[d], None
            if block is not None:
                wait_for(block)
            t = _now()
            self.prof.add(name, (t - self._st0[j]) * 1e-9)
        self._st1[j] = t
        r = self._ranges[d]
        if r is not None:
            self._ranges[d] = None
            r.__exit__(None, None, None)
        self._depth = d - 1
        return False

    def wait(self, tensor):
        """In the profile mode, the innermost open span (if timed) ends when
        the work producing ``tensor`` has finished; otherwise nothing."""
        d = self._depth
        if self._timed[d] is not None:
            self._block[d] = tensor

    def frame(self, ts, prof=None):
        """Open the next frame (stamp ``ts``) and its ``frame`` span.  With a
        ``prof``, the frame's time to the end of the work of the tensor given
        to ``end_frame`` goes to ``frame_total`` and ``kf_step`` or
        ``track_step``."""
        k = self.n_frames
        self.n_frames = k + 1
        m = k & self._fmask
        self._fts[m] = float(ts)
        self._fkf[m] = 0
        self._fspan[m] = self.n_spans
        self._cur = k
        self._annot = _profiling()
        self._frame_prof = prof
        self.span("frame")
        return self._frame_cm

    def end_frame(self, is_kf, block=None):
        """The open frame's keyframe flag, and the tensor its profiled time waits for."""
        self._fkf[self._cur & self._fmask] = 1 if is_kf else 0
        if self._frame_prof is not None:
            self._frame_block = block

    def _end_frame(self):
        prof, self._frame_prof = self._frame_prof, None
        self.prof = None
        if prof is not None:
            block, self._frame_block = self._frame_block, None
            if block is not None:
                wait_for(block)
            j = self._stack[self._depth] & self._smask
            dt = (_now() - self._st0[j]) * 1e-9
            kf = self._fkf[self._cur & self._fmask]
            for name in ("frame_total", "kf_step" if kf else "track_step"):
                prof.add(name, dt)
        self.__exit__()
        self._cur = -1
        self._annot = None

    def snapshot(self) -> dict:
        """Copies of the records still in the rings, oldest first:
        ``frames`` (seq, ts, is_kf, span) and ``spans`` (index, frame, name,
        parent, t0, t1, count), numpy arrays; ``names``, the name of each
        id.  A span still open reads t1 = -1."""
        nf, ns = self.n_frames, self.n_spans
        fi = np.arange(max(0, nf - len(self.frame_ts)), nf)
        si = np.arange(max(0, ns - len(self.span_t0)), ns)
        fr, sr = fi & self._fmask, si & self._smask
        spans = {"index": si, "frame": self.span_frame[sr], "name": self.span_name[sr],
                 "parent": self.span_parent[sr], "t0": self.span_t0[sr],
                 "t1": self.span_t1[sr], "count": self.span_count[sr]}
        for i in self._stack[1:self._depth + 1]:
            spans["t1"][si == i] = -1
        return {"frames": {"seq": fi, "ts": self.frame_ts[fr],
                           "is_kf": self.frame_kf[fr].astype(bool),
                           "span": self.frame_span[fr]},
                "spans": spans, "names": list(self.names)}
