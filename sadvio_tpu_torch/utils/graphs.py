"""CUDA-graph capture of the pipeline's stages: the port's ``jax.jit``.

The JAX package compiles each stage of its frame loop into one fixed-shape
program.  Here a stage method decorated with ``@stage`` runs the same way on
a CUDA device: each *variant* of its arguments is captured once into a CUDA
graph and then replayed.  A variant is keyed by the shapes, dtypes and
devices of the tensor leaves of the arguments, by the structure around them
(which optional arguments are None), by the Python scalars among them
(flags such as ``vio`` or ``fixed_n`` that select code) and by the named
attributes of the instance that select code (``key_attrs``).  A scalar that
changes from call to call must come in as a 0-d tensor: as a key it would
capture a new graph each time, and a stage whose variant count passes
``MAX_VARIANTS`` raises.

The first call of a variant runs the method eagerly on a side stream
(the warm-up: its result is the call's result), then captures it into a
graph whose inputs are copies of the call's tensors.  Later calls copy
their tensors into those static inputs, replay the graph on the current
stream and return clones of the static outputs, so nothing the caller keeps
aliases memory that the next replay writes.  The graphs that replay on one
stream share one memory pool; a stage replayed on another stream (the
back end on its own stream, ``parallel/pipeline_parallel.py``) gets that
stream's pool.  Replays run under ``torch.cuda.set_sync_debug_mode("error")``:
a host synchronisation there raises.  A capture that fails and a replay
that raises propagate: nothing falls back to the eager method.

Kernel launch counts (``ops.klt_kernel``, ``models.imu.preintegrate``): the
launches a capture records did not run, so they are taken off the counts
after the capture and added back at every replay.

Spans (``utils/profiler.Recorder``, the instance's ``graphs.trace``): every
stage call is a span named after the stage; a replay adds ``graphs.launch``
(``CUDAGraph.replay()``; count: the graph's nodes, read once at capture).
The host's other work of a replay (the key, the copies in, the clones out)
is in ``Variant.replay_s`` with the launch.  The launch enters no profiler
range of its own: in a trace the graph's kernels stay under the stage's
range, and a device gap named by the bare stage is the host inside the
stage call (the key, the copies, the launch or the clones).

On the CPU the method runs as it is.  ``eager()`` runs the plain methods on
the card too (the counterpart of ``jax.disable_jit``), for comparisons and
debugging.  On the card every stage call, eager or captured, prefers
cuSOLVER for ``torch.linalg``: other routes (MAGMA) read results on the
host.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import functools
import time

import torch

from sadvio_tpu_torch.models import imu
from sadvio_tpu_torch.ops import klt_kernel

MAX_VARIANTS = 16  # more variants of one stage mean a per-call scalar leaked into the key

_EAGER = contextvars.ContextVar("sadvio_graphs_eager", default=False)


@contextlib.contextmanager
def eager():
    """Within this context the stages run their plain methods on the card."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


@contextlib.contextmanager
def _cusolver():
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


@contextlib.contextmanager
def _no_sync():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ----------------------------------------------------------------------
# argument nests: tensors, tuples, lists, dicts, dataclasses, NamedTuples
# ----------------------------------------------------------------------


def _flatten(x, leaves: list):
    """A hashable description of the nest ``x``; its tensors go to ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("T", tuple(x.shape), x.dtype, x.device)
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("V", type(x), x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("N", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return ("S", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("D", dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("C", type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves))
                                    for f in dataclasses.fields(x)))
    raise TypeError(f"a captured stage cannot take or return {type(x).__name__}")


def _unflatten(spec, leaves):
    """The nest of ``spec`` with its tensors taken in order from the iterator ``leaves``."""
    if spec[0] == "T":
        return next(leaves)
    kind, typ, body = spec
    if kind == "V":
        return body
    if kind == "N":
        return typ(*[_unflatten(s, leaves) for s in body])
    if kind == "S":
        return typ(_unflatten(s, leaves) for s in body)
    if kind == "D":
        return {k: _unflatten(s, leaves) for k, s in body}
    return typ(**{name: _unflatten(s, leaves) for name, s in body})


# ----------------------------------------------------------------------
# kernel launch counts
# ----------------------------------------------------------------------

_COUNTED = (klt_kernel.lk_iterate, klt_kernel.lk_track, imu.preintegrate)


def _launch_counts():
    out = {}
    for fn in _COUNTED:
        out[(fn, None)] = fn.launches
        for k, n in getattr(fn, "launches_by_levels", {}).items():
            out[(fn, k)] = n
    return out


def _add_launches(delta, sign=1):
    for (fn, k), n in delta.items():
        if k is None:
            fn.launches += sign * n
        else:
            fn.launches_by_levels[k] = fn.launches_by_levels.get(k, 0) + sign * n


# ----------------------------------------------------------------------
# graphs
# ----------------------------------------------------------------------


def _captured_nodes(stream) -> int:
    """The nodes captured so far into the graph that ``stream`` is capturing
    (``cuStreamGetCaptureInfo_v2`` of ``libcuda``, then ``cuGraphGetNodes``
    on the graph it names; neither adds to the capture)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
    deps, n_deps, n = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_size_t()
    err = cuda.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), ctypes.byref(cid),
        ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n_deps))
    if err or not graph.value:
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2 failed with CUresult {err}")
    err = cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


@dataclasses.dataclass
class Variant:
    """One captured variant of a stage."""

    graph: torch.cuda.CUDAGraph
    static_in: list
    out_spec: tuple
    static_out: list
    launches: dict  # kernel launches recorded in the graph, per counter
    capture_ms: float
    nodes: int  # nodes of the graph
    replays: int = 0
    replay_s: float = 0.0  # host seconds in the replays: copies in, launch, clones out


class StageGraphs:
    """The captured variants of every stage of one pipeline instance, the
    side stream their warm-ups and captures run on, and one memory pool per
    replay stream."""

    def __init__(self, device, trace):
        self.device = torch.device(device)
        self.trace = trace  # the pipeline's span recorder (utils/profiler.py)
        self.variants = {}  # stage name -> {key: Variant}
        self._pools = {}  # replay stream -> graph memory pool
        self._side = None

    def call(self, name, fn, obj, args, kwargs, key_attrs):
        """One call of the stage ``name``, inside its span (``stage``)."""
        t0 = time.perf_counter()
        leaves = []
        spec = _flatten((args, kwargs), leaves)
        key = (spec, tuple(getattr(obj, a) for a in key_attrs))
        table = self.variants.setdefault(name, {})
        var = table.get(key)
        if var is None:
            if len(table) >= MAX_VARIANTS:
                raise RuntimeError(f"stage {name}: more than {MAX_VARIANTS} variants; a value "
                                   f"that changes per call is keying the capture")
            out, table[key] = self._capture(fn, obj, args, kwargs, spec, leaves)
            return out
        with _no_sync():
            for dst, src in zip(var.static_in, leaves):
                dst.copy_(src)
            with self.trace.span("graphs.launch", var.nodes, annotate=False):
                var.graph.replay()
            out = [t.clone() for t in var.static_out]
        _add_launches(var.launches)
        var.replays += 1
        out = _unflatten(var.out_spec, iter(out))
        var.replay_s += time.perf_counter() - t0
        return out

    def _capture(self, fn, obj, args, kwargs, spec, leaves):
        klt_kernel._library()  # built and loaded before any capture
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side = self._side
        # warm-up: the eager run on the side stream is this call's result
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(obj, *args, **kwargs)
        main.wait_stream(side)
        out_leaves = []
        _flatten(out, out_leaves)
        for t in out_leaves:
            t.record_stream(main)
        for t in leaves:
            t.record_stream(side)

        static_in = [t.clone() for t in leaves]
        s_args, s_kwargs = _unflatten(spec, iter(static_in))
        pool = self._pools.setdefault(main.cuda_stream, torch.cuda.graph_pool_handle())
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=side):
            s_out = fn(obj, *s_args, **s_kwargs)
            nodes = _captured_nodes(side)
        capture_ms = (time.perf_counter() - t0) * 1e3
        after = _launch_counts()
        recorded = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        _add_launches(recorded, -1)  # recorded, not launched: counted at each replay
        static_out = []
        out_spec = _flatten(s_out, static_out)
        return out, Variant(graph, static_in, out_spec, static_out, recorded, capture_ms, nodes)


def stage(fn=None, *, key_attrs=(), eager_if=None):
    """Decorate a stage method of a class whose instances carry ``device``
    and ``graphs`` (a ``StageGraphs``).  ``key_attrs``: attributes of the
    instance that select code.  ``eager_if(self, *args, **kwargs)``: calls
    for which the stage stays eager on the card (a path not captured yet).
    Every call, eager or captured, is a span named after the stage."""
    if fn is None:
        return functools.partial(stage, key_attrs=key_attrs, eager_if=eager_if)
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.graphs.trace.span(name):
            if self.device.type != "cuda":
                return fn(self, *args, **kwargs)
            with _cusolver():
                if _EAGER.get() or (eager_if is not None and eager_if(self, *args, **kwargs)):
                    return fn(self, *args, **kwargs)
                return self.graphs.call(name, fn, self, args, kwargs, key_attrs)

    wrapper.captured = True
    return wrapper
