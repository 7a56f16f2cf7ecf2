"""Stage profiler: tic/toc stack, running averages and the profiler dump.

Port of ``sadvio_tpu/utils/profiler.py``.  Work on the card is queued, so a
stage is timed by waiting for its output: ``toc(name, block=tensor)`` calls
``torch.cuda.synchronize()`` when ``tensor`` lies on a CUDA device, and
nothing more on the CPU, where every op has finished when it returns.
Per-stage timing serializes the frame loop: it is for the profiler dump,
not for the steady-state loop.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


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
        self.sums[name] += dt
        self.counts[name] += 1
        return dt

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
