"""What the benchmark's own files record around the calls into the
pipeline's stages, from the instance (each stage method is wrapped on the
``StereoSLAM``/``MonoSLAM`` object; the program is not changed):

- spans: a CUDA event before and after each call of the measured window
  (``--trace 1``), read once the window has closed, keyed by the frame the
  call belongs to;
- annotations: in the traced frames after the window, a
  ``torch.profiler.record_function`` range named after the stage, so that
  the trace can say what the host was doing;
- samples: for the comparison that decides ``correct``, the inputs and
  outputs of a few calls of each compared stage, drawn from the seed
  (reservoir sampling: every call of the window is equally likely to be
  kept), copied on the device so that nothing the pipeline does later can
  change them;
- the live LK slots handed to ``_frontend`` (``tracks.valid[0]``) in the
  traced frames, for the ``lk_track`` bound.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

STAGES = ("_preint", "_pyramids", "_frontend", "_insert_kf", "_backend", "_marg_roll")


def clone_tree(x):
    """A copy of a nest of tensors (tuples, lists, dicts, dataclasses,
    NamedTuples) with every tensor cloned; other leaves are shared."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[clone_tree(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: clone_tree(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


class Hooks:
    """Wrap the stages of ``slam``.  ``keep``: {stage: calls to keep for the
    comparison}; ``seed``: the draw of which calls.  Nothing is recorded
    until ``active`` is set (the measured window)."""

    def __init__(self, slam, keep: dict, seed: int, spans: bool = False):
        self.keep = keep
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 13])
        self.seen = {name: 0 for name in keep}
        self.samples = {name: [] for name in keep}
        self.spans = spans
        self.events = {name: [] for name in STAGES}  # (frame, start event, end event)
        self.live = []  # (live slots as a 0-d device tensor, level-0 (H, W)) per traced call
        self.active = False  # the measured window: samples and spans
        self.annotate = False  # the traced frames: profiler ranges and live-slot counts
        self.frame = -1
        self.inner = {}  # the stage methods the wrappers call, by name
        for name in STAGES:
            if hasattr(slam, name):
                self.inner[name] = getattr(slam, name)
                setattr(slam, name, self._wrap(name))

    def _draw(self, name):
        """The slot of this call in the stage's reservoir, or None."""
        k = self.keep.get(name, 0)
        if not k:
            return None
        n = self.seen[name]
        self.seen[name] = n + 1
        if n < k:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < k else None

    def _wrap(self, name):
        def call(*args, **kwargs):
            fn = self.inner[name]
            if self.annotate:
                if name == "_frontend":
                    tracks, pyr_new = args[2], args[1]
                    self.live.append((tracks.valid[0].sum(), tuple(pyr_new[0][0].shape)))
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            if not self.active:
                return fn(*args, **kwargs)
            slot = self._draw(name)
            inputs = clone_tree((args, kwargs)) if slot is not None else None
            if self.spans:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            out = fn(*args, **kwargs)
            if self.spans:
                t1.record()
                self.events[name].append((self.frame, t0, t1))
            if slot is not None:
                rec = (self.frame, inputs, clone_tree(out))
                if slot < len(self.samples[name]):
                    self.samples[name][slot] = rec
                else:
                    self.samples[name].append(rec)
            return out

        return call

    def span_ms(self):
        """{stage: [(frame, device ms), ...]} of the window's calls; waits
        for the device."""
        torch.cuda.synchronize()
        return {name: [(f, a.elapsed_time(b)) for f, a, b in ev]
                for name, ev in self.events.items()}
