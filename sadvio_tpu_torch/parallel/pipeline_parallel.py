"""Front end and back end on two CUDA streams (config ``multithreading``).

Port of ``sadvio_tpu/parallel/pipeline_parallel.py`` (``BackendExecutor``).
The reference overlaps its frame-rate front end and its keyframe-rate back
end with two threads sharing a map under a mutex; the JAX package routes
the back-end step to a second device through async dispatch.  Here the back
end runs on a second CUDA stream of the same card: ``submit_fn`` makes the
side stream wait for the work that produced the inputs and queues the step
on it, and ``collect`` makes the caller's stream wait on the step's event
before any later work, host reads included, touches the result.

The pipeline submits and collects in one call, as the JAX package does, so
the trajectory is the synchronous one.  On the CPU there are no streams:
the step runs when it is submitted.  A captured step (``utils/graphs.py``)
replays on the side stream from that stream's own graph memory pool, so it
never shares memory with a front-end graph that could replay beside it.
"""

from __future__ import annotations

import dataclasses

import torch


def _tensors(x):
    """Every tensor in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


class BackendExecutor:
    """Runs one back-end step at a time on a side stream of ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._pending = None
        self.steps = 0  # steps submitted

    def submit_fn(self, fn, *args):
        """Queue ``fn(*args)`` on the side stream; ``collect`` returns it."""
        if self._pending is not None:
            raise RuntimeError("backend step already in flight; collect() first")
        self.steps += 1
        if self.stream is None:
            self._pending = (fn(*args), None)
            return
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
            done = torch.cuda.Event()
            done.record(self.stream)
        # the inputs were made on the caller's stream and are read on the
        # side one: the allocator must not hand their memory out before
        # the side stream is done with it
        for t in _tensors(args):
            t.record_stream(self.stream)
        self._pending = (out, done)

    def collect(self):
        """The step's result; the caller's stream waits for it first."""
        if self._pending is None:
            raise RuntimeError("nothing submitted")
        out, done = self._pending
        self._pending = None
        if done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(done)
            for t in _tensors(out):
                t.record_stream(main)
        return out
