"""Run one cell of the port's benchmark on one card and print its result.

    python3 -m portbench.run --workload stereo_vio.replay --seed 7 --seconds 10 --trace 0

From the root of a checkout.  The run builds its world from ``--seed``
(``world.py``), builds the pipeline of the cell's configuration
(``program.py``), warms up until VIInit has fired, the window has rolled and
a whole keyframe period captured no new stage variant, then drives the
recorded sequence closed loop for ``--seconds``.  With ``--trace 0`` it
reports the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy time and a breakdown from the profiler's trace.
Then it holds what the window produced to the plain reference
(``check.py``) and prints the numbers compared, each beside its limit, as the
last lines on standard error and as the last key of the result, which is the
last line on standard output.  ``--readings 1`` also computes the control
of the stage gaps (the reference in TF32) and prints both sets of gaps;
``--control 1`` runs the whole program with TF32 on.  The benchmark's own
runs pass neither.

Exit codes: 0 with a result; 2 without the card(s) the cell asks for; 3 when
JAX or the JAX package is loaded in this process once the window has closed;
any other failure raises.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sadvio_tpu")
CACHE = ROOT / ".portbench_cache"  # fixed kernel-cache directories inside the checkout
TRACE_SECONDS = 2.0  # seconds of frames under the profiler after the window (--trace 1)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _set_environment():
    """Kernel caches in fixed directories of the checkout, and one host
    thread for PyTorch's and the BLAS libraries' CPU pools: the frame loop is
    one Python thread, and idle pool threads spinning beside it only add
    noise to its timings."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def _replay_s(slam) -> float:
    return sum(x.replay_s for v in slam.graphs.variants.values() for x in v.values())


def run(cell, seed: int, seconds: float, trace: bool, device, readings: bool = False,
        control: bool = False, fault=None, root: Path = ROOT) -> dict:
    """One run of ``cell`` on ``device``; the result's dict.  ``fault``: a
    function given the ``Hooks`` after warm-up, which may replace the stage
    methods they call (``hooks.inner``): tests break the timed path under
    the recording with it."""
    import numpy as np
    import torch

    from portbench import cells, check, hooks as hooks_mod, program, trace as trace_mod
    from portbench import world as world_mod

    cuda = torch.device(device).type == "cuda"
    if control:
        import sadvio_tpu_torch  # noqa: F401  (its import turns TF32 off)

        # the program's float32 products and convolutions in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    torch.zeros(1, device=device)
    parts = {"imports_cuda_s": time.perf_counter() - T_START}
    parts["kernels_s"] = program.build_kernels(device)
    traffic = cell.traffic
    # the same sequence with and without the trace: room for the traced frames
    n_frames = (int(traffic["warmup_frames_max"]) + int(traffic["settle_frames"]) + 1
                + math.ceil(float(traffic["max_frames_per_s"]) * (seconds + TRACE_SECONDS)))
    t = time.perf_counter()
    world = world_mod.make_world(cell.config, traffic, seed, n_frames, device)
    parts["world_s"] = time.perf_counter() - t
    t = time.perf_counter()
    slam = program.make_slam(cell.config, device, seed)
    hooks = hooks_mod.Hooks(slam, check.KEEP, seed, spans=trace and cuda)
    loop = program.Loop(slam, world.frames)
    warm = program.warm_up(loop, int(traffic["warmup_frames_max"]),
                           int(traffic["settle_frames"]))
    parts["warmup_s"] = time.perf_counter() - t
    parts["warmup_frames"] = warm["frames"]
    if fault is not None:
        fault(hooks)
    i0 = loop.i
    replay0 = _replay_s(slam)
    setup_s = time.perf_counter() - T_START
    print(json.dumps({"setup_s": setup_s, "setup_parts": parts}), flush=True)

    latency, is_kf, poses = [], [], []
    # the world's frames and the pipeline's set-up objects leave the
    # collector's generations: a collection in the window walks only what
    # the window makes
    gc.collect()
    gc.freeze()
    hooks.active = True
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        hooks.frame = len(latency)
        dt, kf, out = loop.step()
        latency.append(dt)
        is_kf.append(kf)
        poses.append(out.get("pose"))
    window_s = time.perf_counter() - t0
    hooks.active = False
    replay_s = _replay_s(slam) - replay0
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = None
    if trace:
        # the profiler slows the host, so it covers frames after the
        # measured window, and the spans and counters come from the window
        prof = trace_mod.profiler()
        prof.start()
        hooks.annotate = True
        with torch.profiler.record_function(trace_mod.WINDOW):
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < TRACE_SECONDS:
                with torch.profiler.record_function("frame"):
                    loop.step()
            if cuda:
                torch.cuda.synchronize()
        hooks.annotate = False
        prof.stop()
        traced = trace_mod.reduce(prof)
        del prof

    rec = {"latency_s": latency, "is_kf": is_kf, "window_s": window_s, "setup_s": setup_s,
           "replay_s": replay_s, "config": cell.config}
    if trace:
        rec["spans"] = hooks.span_ms() if cuda else {}
        rec["live"] = [(int(n), shape) for n, shape in hooks.live]
        rec["trace"] = traced
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name, unit in names:
        value = cells.reader(name, root)(rec)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}

    finite = [p is not None and np.isfinite(p[0]).all() and np.isfinite(p[1]).all()
              for p in poses]
    mono = cell.config["slam_mode"] in ("mono", "monovio")
    ate_m = check.worst_segment_ate(np.cumsum(latency), [p[1] if ok else None for p, ok
                                                         in zip(poses, finite)],
                                    world.gt_t[i0:i0 + len(poses)], with_scale=mono)

    # the reference runs once the window's state is freed
    samples = hooks.samples
    del slam, loop, hooks, world
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    refs = check.reference_outputs(cell.config, samples, device)
    nums = check.numbers(samples, refs)
    nums["ate_m"] = ate_m
    compared = {k: {"value": nums.get(k, math.inf), "limit": float(lim)}
                for k, lim in cell.limits.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    check_s = time.perf_counter() - t_check

    result = {"correct": bool(correct), "attempted": len(latency),
              "failed": int(len(finite) - sum(finite)), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        tr = rec["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["check_s"] = check_s
    if readings:
        ctrl = check.control_numbers(
            refs, check.reference_outputs(cell.config, samples, device, tf32=True))
        result["readings"] = {"program": nums, "control": ctrl,
                              "kept": {k: len(v) for k, v in samples.items()}}
    result["check"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_environment()
    import torch

    torch.set_num_threads(1)

    from portbench import cells

    cell = cells.load(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 readings=bool(args.readings), control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the result's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    if "readings" in result:
        print(json.dumps({"readings": result["readings"]}), file=sys.stderr)
    sys.stderr.flush()
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
