#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the LK kernels from
the sources in this checkout, checks each against its plain PyTorch version
at the main path's shapes, then drives the flagship stereo-VIO main path
(``StereoSLAM(rig, cfg, imu_params).run``) at EuRoC shapes, the long-run
path (global map, pose graph with loop closure, mesh) on a revisit world,
the matcher / epipolar front end, the monocular modes (``MonoSLAM``), the
non-overlapping-FoV mode (``NoFovSLAM``) and the exotic camera models with
the angular BA, and checks each against ground truth.

    python3 chip_smoke.py             # the whole check
    python3 chip_smoke.py --measure   # adds lk_track's cycles per phase, the
                                      # end-to-end comparison of the two KLT
                                      # engines, the stage tables, the
                                      # kernels-per-frame count and the kernel
                                      # counts of the long-run stages
    python3 chip_smoke.py --sweep     # adds the long run at other lengths
                                      # and seeds, failures printed only
    python3 chip_smoke.py --parent DIR  # adds lk_iterate of the checkout
                                        # unpacked under DIR, timed in turns

Phases: environment; build; ``lk_iterate`` against ``lk_iterate_ref`` on the
four pyramid levels; ``lk_track`` against ``lk_track_ref`` and against the
five-launch ``track(engine="levels")`` in the frame-track and stereo-track
call shapes, and at ``levels=1`` in the matcher's polish call shape; the
130-frame main path on ``engine="fused"``; its first frames again on
``engine="levels"``; the long-run path (752x480, K=11, L=512, ``global_map``,
``pose_graph``, ``mesh3d``) over an excursion that returns to its start, with
its new stages timed; ``tracker: matcher`` and ``pose_estimator: epipolar``
runs; the marginalization products of a window captured at a roll of the
long run, evaluated on the card and on the CPU and compared; the mono and
monovio runs (configs/euroc_mono(vio), 130 frames of camera 0), then
``lk_track`` at the mono frame track's real inputs; the nofov run
(configs/nofov's shapes at 640x480, 60 frames, the 1.4x scale corruption),
then ``lk_track`` at its widest warped camera-1 re-track; the exotic runs
(sim_omni_mono, sim_ds_monovio, a fisheye stereo run with the angular BA,
60 frames each).  No phase catches its own failure.

Kernel times are device times: (a) the kernel's self time from
``torch.profiler``; (b) CUDA events around a replayed CUDA graph of 50
launches, which the host cannot hold back.  The wrapper's host cost per
call is printed apart from both.  No single PyTorch call computes an LK
iteration loop or a pyramidal track, so there is no ``library_ms``.

Needs one CUDA device and nvcc (CUDA_HOME or /usr/local/cuda); exits
non-zero without a result when either is missing or any phase fails.  The
last line of stdout is {"ok": true, "device": {...}}; the line before it
lists each kernel with its launch count on the path that drives it, its
largest disagreement with the plain version, its times and its bound.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_FEATURES = 512  # landmark slots L of the main path
RADIUS = 5  # KLT radius: 11 x 11 patches
LEVELS = 4
N_FRAMES = 130  # VIInit fires and the window rolls within this run
N_FRAMES_LEVELS = 20  # the earlier per-level engine's short path
N_FRAMES_FRONTEND = 30  # the matcher and the epipolar runs
# the long-run path: an excursion of 2.2 m along a 16 m wall and back
LONG_FRAMES, LONG_SEED, LONG_POINTS = 320, 11, 640
LONG_SWEEP = ((240, 11), (400, 11), (320, 3))  # other (frames, seed), under --sweep
LONG_CAPTURE_ROLL = 8  # the roll whose window the marginalization check takes
UV_TOL_PX = 5e-3  # kernel vs plain, good features (fp32, different sum order)
ERR_TOL = 1e-3
ATE_TOL_M = 0.05
ENGINES_POS_TOL_M = 0.01  # fused vs levels engine over the short path
ITERS, ITERS_COARSE = 10, 6  # klt.track defaults, as the main path uses them
FB_THRESH, MAX_ERR = 0.5, 20.0
GRAPH_LAUNCHES = 50

# NVIDIA H100 SXM data sheet: device memory rate and float32 rate outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# per patch pixel and iteration: bilinear weights and taps 11, residual 1,
# two multiply-adds 4
FLOP_PER_PIXEL_ITER = 16
FLOP_PER_HALO_PIXEL = 19  # warp 8, bilinear 11
FLOP_PER_TEMPLATE_PIXEL = 10  # two central differences 4, three multiply-adds 6


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# ----------------------------------------------------------------------
# timers
# ----------------------------------------------------------------------


def _graph_ms(fn, n=GRAPH_LAUNCHES, reps=7):
    """Device ms per call of fn: n calls captured into one CUDA graph, the
    graph replayed between two events (median of reps, after a warm-up
    replay).  The host makes one graph launch, so it cannot hold the card
    back.  fn must only launch kernels and allocate (no host copies)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _loop_ms(fn, n=20, warmup=2):
    """ms per call of fn as Python launches it: events around n calls.  When
    the card is faster than the host's launch rate this reads the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _host_us(fn, n=200):
    """Host microseconds per un-synchronised call of fn."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _profile(fn, n=1, required=True):
    """Device activity of n calls of fn by torch.profiler: ({kernel name:
    (count, self device us)}, wall seconds).  With `required` false a
    profile without device time is reported and returned empty: the caller
    keeps its CUDA-event times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    events = prof.key_averages()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key] = (e.count, float(e.self_device_time_total))
    msg = (f"torch.profiler recorded no device time ({len(events)} events: "
           f"{sorted({str(e.device_type) for e in events})})")
    _require(out or not required, msg)
    if not out:
        print(f"profiler: {msg}")
    return out, wall


def _kernel_self_ms(table, name, calls):
    """Self device ms per call of the kernels whose name contains `name`;
    None for an empty table (the profiler recorded no device time)."""
    if not table:
        return None
    hit = [(c, us) for k, (c, us) in table.items() if name in k]
    _require(hit, f"profiler saw no kernel named {name}")
    return sum(us for _, us in hit) / calls / 1e3


def _ms(x, digits=5):
    return "not measured" if x is None else f"{x:.{digits}f} ms"


# ----------------------------------------------------------------------
# bounds: the least time the card could take, from this run's inputs
# ----------------------------------------------------------------------


def _bound(bytes_moved, flop):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_flop = flop / PEAK_FP32_S * 1e3
    return {"bound_ms": max(t_bytes, t_flop), "bound_by": "bytes" if t_bytes >= t_flop
            else "operations", "bytes": int(bytes_moved), "flop": int(flop)}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_lk_iterate(img1, uv, T, gx, gy, nrm, iters):
    """Every input read once, the (N,3) output written once; operations at
    the iteration cap (an upper bound on what the data needs: the bound is
    bytes even so)."""
    N, S = T.shape[0], T.shape[1]
    return _bound(_nbytes(img1, uv, T, gx, gy, nrm) + N * 3 * 4,
                  N * S * S * FLOP_PER_PIXEL_ITER * (iters + 1))


def bound_lk_track(pyr0, pyr1, uv0, uv_init, valid0, warp, bwd_levels, levels=LEVELS):
    N, S = uv0.shape[0], 2 * RADIUS + 1
    ins = [*pyr0[:levels], *pyr1[:levels], uv0, uv_init, valid0]
    ins += [] if warp is None else [warp]
    passes = [ITERS if lvl == 0 else ITERS_COARSE for lvl in range(levels)]
    passes += [ITERS_COARSE] * bwd_levels
    flop = sum(N * ((S + 2) ** 2 * FLOP_PER_HALO_PIXEL + S * S * FLOP_PER_TEMPLATE_PIXEL
                    + S * S * FLOP_PER_PIXEL_ITER * (it + 1)) for it in passes)
    return _bound(_nbytes(*ins) + N * (2 * 4 + 1 + 4), flop)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def phase_env():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    _require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")
    _require(not torch.backends.cudnn.allow_tf32, "TF32 convolution must be off")
    return card


def phase_build():
    from sadvio_tpu_torch.ops import klt_kernel

    info = klt_kernel.build()
    print(f"build: {info['path'].name} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        print(f"build: {line}")


def make_world(device, n_frames, **kw):
    from sadvio_tpu_torch.pipeline import synthetic

    kw = {**dict(seed=5, n_points=400), **kw}
    world = synthetic.make_world(n_frames=n_frames, width=752, height=480, imu_noise=True,
                                 device=device, **kw)
    frames = [f._replace(images=np.clip(f.images, 0, 255).astype(np.uint8))
              for f in world.frames]
    return world, frames


def make_long_world(device, n_frames=LONG_FRAMES, seed=LONG_SEED):
    """The revisit world: pan 2.2 m out along a wider wall and come back."""
    return make_world(device, n_frames, seed=seed, n_points=LONG_POINTS,
                      trajectory="excursion", wall_x=(-5.0, 11.0))


class _ClockSampler:
    """SM clock and power draw sampled once a second by nvidia-smi while a
    phase runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "1000"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append((float(parts[0]), float(parts[1])))
            except (ValueError, IndexError):
                continue
        self.rows = np.asarray(rows).reshape(-1, 2)

    def summary(self):
        if len(self.rows) == 0:
            return "no samples"
        mhz, watt = self.rows[:, 0], self.rows[:, 1]
        return (f"{len(self.rows)} samples: SM clock min/median/max {mhz.min():.0f}/"
                f"{np.median(mhz):.0f}/{mhz.max():.0f} MHz, power draw min/median/max "
                f"{watt.min():.0f}/{np.median(watt):.0f}/{watt.max():.0f} W")


def _iterate_inputs(frame, device):
    """Per pyramid level, the inputs lk_iterate gets on the stereo track of
    one frame: (lvl, img1, uv, T, gx, gy, nrm, good, iters)."""
    from sadvio_tpu_torch.frontend import detect, klt

    imgs = torch.as_tensor(frame.images, device=device).float()
    pyr0 = klt.build_pyramid(imgs[0], LEVELS)
    pyr1 = klt.build_pyramid(imgs[1], LEVELS)
    uv0, _, _ = detect.detect_features(pyr0[0], gh=8, gw=16, k_per_cell=4)
    _require(uv0.shape[0] == N_FEATURES, "detector slot count changed")
    eye = torch.eye(2, device=device).expand(N_FEATURES, 2, 2)
    for lvl in range(LEVELS):
        uv = (uv0 / 2.0 ** lvl).contiguous()
        T, gx, gy, nrm, good = klt._templates(pyr0[lvl], uv, eye, RADIUS, 1e-3)
        yield (lvl, pyr1[lvl].contiguous(), uv, T, gx, gy, nrm, good,
               ITERS if lvl == 0 else ITERS_COARSE)


def phase_kernel(frame, device):
    """lk_iterate vs lk_iterate_ref on the stereo track of one frame, with
    N=512 features and 11x11 templates on every pyramid level."""
    from sadvio_tpu_torch.ops import klt_kernel

    rows = []
    for lvl, img1, uv, T, gx, gy, nrm, good, iters in _iterate_inputs(frame, device):
        run_k = lambda: klt_kernel.lk_iterate(img1, uv, T, gx, gy, nrm, iters=iters)
        run_r = lambda: klt_kernel.lk_iterate_ref(img1, uv, T, gx, gy, nrm, iters=iters)
        out_k, out_r = run_k(), run_r()
        torch.cuda.synchronize()
        fin = torch.isfinite(out_k).all(1) & torch.isfinite(out_r).all(1)
        g = good & fin
        _require(int(g.sum()) > N_FEATURES // 4, f"level {lvl}: {int(g.sum())} good features")
        _require(torch.equal(torch.isfinite(out_k), torch.isfinite(out_r)), "NaN pattern differs")
        d_uv = float((out_k[g, :2] - out_r[g, :2]).abs().max())
        d_err = float((out_k[g, 2] - out_r[g, 2]).abs().max())
        # in turns: plain, kernel, kernel, plain
        ms_r = [_loop_ms(run_r, n=5, warmup=1)]
        ms_graph = [_graph_ms(run_k), _graph_ms(run_k)]
        ms_r.append(_loop_ms(run_r, n=5, warmup=1))
        table, _ = _profile(run_k, n=20)
        row = {"level": lvl, "H": img1.shape[0], "W": img1.shape[1], "iters": iters,
               "good": int(g.sum()), "max_abs_err_uv": d_uv, "max_abs_err_err": d_err,
               "ms": float(np.mean(ms_graph)),
               "profiler_ms": _kernel_self_ms(table, "lk_iterate_kernel", 20),
               "one_launch_ms": _loop_ms(run_k, n=1, warmup=3),
               "host_us": _host_us(run_k), "plain_ms": float(np.mean(ms_r)),
               **bound_lk_iterate(img1, uv, T, gx, gy, nrm, iters)}
        rows.append(row)
        print(f"kernel lk_iterate: level {lvl} {row['H']}x{row['W']} N={N_FEATURES} "
              f"S={2 * RADIUS + 1} iters={iters} good={row['good']} "
              f"max|duv|={d_uv:.3e} px max|derr|={d_err:.3e} | device {row['ms']:.5f} ms "
              f"(graph of {GRAPH_LAUNCHES}) profiler self {row['profiler_ms']:.5f} ms, "
              f"events around one Python call {row['one_launch_ms']:.4f} ms, "
              f"host {row['host_us']:.1f} us/call, plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
              f"({row['bytes']} B, {row['flop']} FLOP at the cap)")
        _require(d_uv < UV_TOL_PX and d_err < ERR_TOL, f"level {lvl}: kernel disagrees")
    return rows


def _track_inputs(frames, device, shape):
    """Inputs of klt.track at the main path's shapes.

    "frame": keyframe -> later frame of camera 0 with a non-identity affine
    warp inside the accepted determinant range, a start a few px off, some
    valid0 false, a few NaN starts, a few features within `radius` of the
    border and a few warps that must count as identity.  "stereo": camera
    0 -> camera 1 of one frame, identity warp, start at uv0.  "polish": the
    matcher's call, the frame inputs at levels=1 with integer-pixel starts
    within a pixel and a half of the answer of the 4-level track."""
    from sadvio_tpu_torch.frontend import detect, klt

    img = lambda k, c: torch.as_tensor(frames[k].images[c], device=device).float()
    pyr0 = klt.build_pyramid(img(0, 0), LEVELS)
    uv0, _, valid0 = detect.detect_features(pyr0[0], gh=8, gw=16, k_per_cell=4)
    N = uv0.shape[0]
    _require(N == N_FEATURES, "detector slot count changed")
    if shape == "stereo":
        pyr1 = klt.build_pyramid(img(0, 1), LEVELS)
        return pyr0, pyr1, uv0.contiguous(), uv0.contiguous(), valid0.contiguous(), None, 1
    pyr1 = klt.build_pyramid(img(4, 0), LEVELS)
    rng = np.random.default_rng(11)
    uv0_h = uv0.cpu().numpy().copy()
    H, W = pyr0[0].shape
    uv0_h[0:4] = [[2.0, 100.0], [W - 3.0, 200.0], [300.0, 1.5], [400.0, H - 2.5]]
    init = uv0_h + rng.uniform(-3.0, 3.0, (N, 2)).astype(np.float32)
    init[4:8] = np.nan
    warp = (np.eye(2, dtype=np.float32) * rng.uniform(0.9, 1.12, (N, 1, 1))
            + rng.uniform(-0.05, 0.05, (N, 2, 2))).astype(np.float32)
    warp[8] = [[1.0, 2.0], [0.5, 1.0]]  # singular
    warp[9] = [[3.0, 0.0], [0.0, 3.0]]  # determinant out of range
    warp[10] = [[np.nan, 0.0], [0.0, 1.0]]
    valid_h = valid0.cpu().numpy() & (rng.uniform(size=N) > 0.1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    uv0_t, warp_t, valid_t = t(uv0_h.astype(np.float32)), t(warp), t(valid_h)
    if shape == "polish":
        uv4, ok4, _ = klt.track(pyr0, pyr1, uv0_t, t(init), valid_t, levels=LEVELS,
                                radius=RADIUS, warp=warp_t, engine="levels")
        start = torch.where(ok4[:, None], torch.round(uv4), uv0_t)
        start = start + t(rng.integers(-1, 2, (N, 2)).astype(np.float32))
        return pyr0, pyr1, uv0_t, start.contiguous(), valid_t & ok4, warp_t, 1
    return pyr0, pyr1, uv0_t, t(init), valid_t, warp_t, 1


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def phase_track_kernel(frames, device):
    """lk_track vs lk_track_ref and vs track(engine="levels") on the card,
    in the frame-track and the stereo-track call shapes and at levels=1 in
    the matcher's polish call shape; times of all three taken in turns."""
    rows = []
    for shape in ("frame", "stereo", "polish"):
        pyr0, pyr1, uv0, init, valid0, warp, bwd = _track_inputs(frames, device, shape)
        levels = 1 if shape == "polish" else LEVELS
        rows.append(_track_kernel_row(shape, pyr0, pyr1, uv0, init, valid0, warp, bwd, levels))
    return rows


def _track_kernel_row(shape, pyr0, pyr1, uv0, init, valid0, warp, bwd, levels,
                      profiler_required=True):
    """One call shape of lk_track: held against lk_track_ref and the
    five-launch engine="levels" track (NaN rows equal, `valid` equal away
    from a gate tie, positions within UV_TOL_PX on features valid in both;
    how many of those differ in any bit, and by how many float32 units in
    the last place at most, is printed), then timed in turns.  Without
    `profiler_required`, a profile that records no device time leaves the
    profiler figures "not measured" (the CUDA-event times stay)."""
    from sadvio_tpu_torch.frontend import klt
    from sadvio_tpu_torch.ops import klt_kernel

    N = uv0.shape[0]
    kw = dict(levels=levels, radius=RADIUS, iters=ITERS, iters_coarse=ITERS_COARSE,
              bwd_levels=bwd)
    run_k = lambda **o: klt_kernel.lk_track(pyr0, pyr1, uv0, init, valid0, warp, **kw, **o)
    run_l = lambda: klt.track(pyr0, pyr1, uv0, init, valid0, warp=warp, engine="levels", **kw)
    run_r = lambda **o: klt_kernel.lk_track_ref(pyr0, pyr1, uv0, init, valid0, warp,
                                                **{**kw, **o})
    out_k, out_l, out_r = run_k(), run_l(), run_r()
    # a feature may differ in `valid` only where its forward-backward
    # distance or its residual is within the float tolerance of the gate
    tight = run_r(fb_thresh=FB_THRESH - UV_TOL_PX, max_err=MAX_ERR - ERR_TOL)[1]
    loose = run_r(fb_thresh=FB_THRESH + UV_TOL_PX, max_err=MAX_ERR + ERR_TOL)[1]
    torch.cuda.synchronize()
    _require(_same_bits(out_k, run_k(margin=0)) and _same_bits(out_k, run_k(margin=9)),
             f"{shape}: lk_track depends on its window margin")
    worst = {"uv": 0.0, "err": 0.0}
    for name, (uv_o, v_o, e_o) in (("lk_track_ref", out_r), ("engine=levels", out_l)):
        uv_k, v_k, e_k = out_k
        _require(torch.equal(torch.isnan(uv_k), torch.isnan(uv_o))
                 and torch.equal(torch.isnan(e_k), torch.isnan(e_o)),
                 f"{shape}: NaN pattern differs from {name}")
        for v in (v_k, v_o):
            _require(bool((v | ~tight).all()) and bool((loose | ~v).all()),
                     f"{shape}: valid differs from {name} away from a gate tie")
        ties = int((v_k != v_o).sum())
        _require(ties <= N // 100, f"{shape}: {ties} gate ties against {name}")
        both = v_k & v_o
        _require(int(both.sum()) > N // 8, f"{shape}: {int(both.sum())} valid")
        d_uv = float((uv_k[both] - uv_o[both]).abs().max())
        d_err = float((e_k[both] - e_o[both]).abs().max())
        nan_rows = int(torch.isnan(uv_k).any(1).sum())
        bits = lambda x: x[both].view(torch.int32).long()
        n_off = int((bits(uv_k) != bits(uv_o)).any(1).sum())
        ulps = int((bits(uv_k) - bits(uv_o)).abs().max()) if n_off else 0
        print(f"kernel lk_track: {shape} track vs {name}: valid in both {int(both.sum())} "
              f"of {N}, gate ties {ties}, NaN rows {nan_rows}, "
              f"max|duv|={d_uv:.3e} px max|derr|={d_err:.3e}, positions differing in any bit "
              f"{n_off} (at most {ulps} float32 units in the last place)")
        _require(d_uv < UV_TOL_PX and d_err < ERR_TOL, f"{shape}: lk_track disagrees with {name}")
        worst = {"uv": max(worst["uv"], d_uv), "err": max(worst["err"], d_err)}

    # in turns: plain, levels, fused, fused, levels, plain
    ms_r = [_loop_ms(run_r, n=3, warmup=1)]
    ms_l = [_loop_ms(run_l)]
    ms_k = [_graph_ms(run_k), _graph_ms(run_k)]
    ms_l.append(_loop_ms(run_l))
    ms_r.append(_loop_ms(run_r, n=3, warmup=1))
    n_prof = 10
    tab_k, _ = _profile(run_k, n=n_prof, required=profiler_required)
    tab_l, _ = _profile(run_l, n=n_prof, required=profiler_required)
    row = {"shape": shape, "max_abs_err_uv": worst["uv"], "max_abs_err_err": worst["err"],
           "ms": float(np.mean(ms_k)),
           "profiler_ms": _kernel_self_ms(tab_k, "lk_track_kernel", n_prof),
           "python_loop_ms": _loop_ms(run_k), "host_us": _host_us(run_k),
           "plain_ms": float(np.mean(ms_r)),
           "levels_python_loop_ms": float(np.mean(ms_l)),
           "levels_device_ms": (sum(us for _, us in tab_l.values()) / n_prof / 1e3
                                if tab_l else None),
           "levels_lk_iterate_device_ms": _kernel_self_ms(tab_l, "lk_iterate_kernel", n_prof),
           "levels_kernels": sum(c for c, _ in tab_l.values()) / n_prof if tab_l else None,
           "levels_host_us": _host_us(run_l, n=20),
           **bound_lk_track(pyr0, pyr1, uv0, init, valid0, warp, bwd, levels)}
    H, W = pyr0[0].shape
    print(f"kernel lk_track: {shape} track {H}x{W} N={N} S={2 * RADIUS + 1} levels={levels} "
          f"| fused: device {row['ms']:.5f} ms (graph of {GRAPH_LAUNCHES}), profiler self "
          f"{_ms(row['profiler_ms'])}, as Python launches it {row['python_loop_ms']:.4f} ms, "
          f"host {row['host_us']:.1f} us/call | engine=levels: {row['levels_kernels']} "
          f"kernels, device {_ms(row['levels_device_ms'], 4)} (profiler, all kernels; "
          f"lk_iterate alone {_ms(row['levels_lk_iterate_device_ms'])}), as Python launches "
          f"it {row['levels_python_loop_ms']:.3f} ms, host {row['levels_host_us']:.0f} us/call "
          f"| plain {row['plain_ms']:.2f} ms | bound {row['bound_ms']:.5f} ms by "
          f"{row['bound_by']} ({row['bytes']} B, {row['flop']} FLOP at the cap)")
    return row


MAIN_CAPS = dict(K=11, L=512, P=48, pyr_levels=LEVELS, klt_radius=RADIUS)
STAGES = ("_pyramids", "_accumulate_imu", "_frontend", "_insert_kf", "_template_cache",
          "_backend", "_marg_roll", "_run_vi_init")


def _time_stages(slam, names=STAGES):
    """Wrap the pipeline's stages with a synchronised host clock; returns
    {stage: [ms, ...]} filled as the run goes."""
    log = {name: [] for name in names}

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    for name in names:
        setattr(slam, name, wrap(name, getattr(slam, name)))
    return log


LONG_STAGES = (("detect", "brief_describe"), ("gmap", "resurrect"), ("marg", "marginalize_relative"),
               ("mesh", "Mesher.update"), ("mesh", "delaunay_triangles"), ("mesh", "zncc_validate"),
               ("mesh", "raycast_pointcloud"))


class _TimedFunctions:
    """Time stage functions (of a module, or of a class in it) with a
    synchronised host clock while a run goes: {"module.function": [ms, ...]}.
    The functions are looked up through their owners at call time, so
    patching the attribute is enough; the originals are put back on exit."""

    def __init__(self, names=LONG_STAGES):
        from sadvio_tpu_torch.backend import marginalization as marg
        from sadvio_tpu_torch.data import globalmap as gmap
        from sadvio_tpu_torch.frontend import detect
        from sadvio_tpu_torch.mesh import mesh

        mods = dict(detect=detect, gmap=gmap, marg=marg, mesh=mesh)
        self.targets = []
        for m, path in names:
            *owners, fn = path.split(".")
            owner = mods[m]
            for name in owners:
                owner = getattr(owner, name)
            self.targets.append((owner, fn))
        self.log = {f"{m}.{fn}": [] for m, fn in names}
        self.calls = {}  # the last call's arguments, for replays under the profiler

    def __enter__(self):
        self.saved = [(owner, fn, getattr(owner, fn)) for owner, fn in self.targets]
        for (owner, fn, orig), key in zip(self.saved, self.log):
            setattr(owner, fn, self._wrap(key, orig))
        return self

    def _wrap(self, key, orig):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            self.log[key].append((time.perf_counter() - t0) * 1e3)
            self.calls[key] = (orig, a, k)
            return out
        return timed

    def __exit__(self, *exc):
        for owner, fn, orig in self.saved:
            setattr(owner, fn, orig)


def run_slam(world, frames, device, engine, caps=MAIN_CAPS, stages=False, profile_frames=(),
             cfg_kw=None, capture_roll=None):
    """Drive StereoSLAM over `frames` on `engine`; returns the run's record.
    Launch counts are set to 0 just before the first frame and read just
    after the last.  `profile_frames` (first, last) puts torch.profiler
    around those frames.  `cfg_kw` overrides config keys.  `capture_roll`
    keeps a copy of what the n-th VIO window roll was given."""
    from sadvio_tpu_torch.ops import klt_kernel
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    cfg = SLAMConfig(slam_mode="bimonovio", max_kf_number=10, min_lmk_number=40,
                     max_movement_parallax=1.0, min_movement_parallax=0.02,
                     async_health=False,
                     caps=Capacities(**caps), **(cfg_kw or {}))
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device=device)
    slam.klt_engine = engine
    captured = {}
    if capture_roll is not None:
        roll = slam._marg_roll

        def capturing(window, obs, imu, priors, tracks, vio, **k):
            captured["n"] = captured.get("n", 0) + bool(vio)
            if vio and captured["n"] == capture_roll:
                captured["state"] = (window, obs, imu, priors)  # stages replace, never write in place
            return roll(window, obs, imu, priors, tracks, vio, **k)

        slam._marg_roll = capturing
    stage_log = _time_stages(slam) if stages else None
    klt_kernel.lk_iterate.launches = 0
    klt_kernel.lk_track.launches = 0
    klt_kernel.lk_track.launches_by_levels = {}
    frame_ms, is_kf, prof, outs = [], [], None, []
    t_run = time.perf_counter()
    for i, f in enumerate(frames):
        if profile_frames and i == profile_frames[0]:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        t0 = time.perf_counter()
        out = slam.process_frame(f)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        is_kf.append(bool(out["is_kf"]))
        outs.append(out)
        if profile_frames and i == profile_frames[1]:
            prof_wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
    run_s = time.perf_counter() - t_run
    rec = {"engine": engine, "slam": slam, "frames": len(frames), "run_s": run_s,
           "frame_ms": np.asarray(frame_ms), "is_kf": np.asarray(is_kf),
           "lk_iterate": klt_kernel.lk_iterate.launches, "lk_track": klt_kernel.lk_track.launches,
           "lk_track_by_levels": dict(klt_kernel.lk_track.launches_by_levels),
           "stages": stage_log, "outs": outs, "captured": captured.get("state")}
    est = np.asarray([t for _, _, t in slam.traj])
    _require(len(est) == len(frames), "one pose per frame expected")
    _require(np.isfinite(est).all() and all(np.isfinite(R).all() for _, R, _ in slam.traj),
             "non-finite pose")
    rec["est"] = est
    rec["ate"] = synthetic.ate_rmse(est, world.gt_t[: len(est)])
    if prof is not None:
        n = profile_frames[1] - profile_frames[0] + 1
        _require(not rec["is_kf"][profile_frames[0]: profile_frames[1] + 1].any(),
                 "a keyframe fell into the profiled tracking frames")
        dev = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        rec["profile"] = {
            "frames": n, "kernels_per_frame": sum(c for _, c, _ in dev) / n,
            "device_ms_per_frame": sum(us for _, _, us in dev) / n / 1e3,
            "wall_ms_per_frame": prof_wall / n * 1e3,
            "lk_ms_per_frame": sum(us for k, _, us in dev if "lk_" in k and "_kernel" in k)
            / n / 1e3}
    return rec


def _describe(rec):
    slam, ms, kf = rec["slam"], rec["frame_ms"], rec["is_kf"]
    return (f"engine={rec['engine']} frames={rec['frames']} keyframes={len(slam.kf_traj)} "
            f"rolls={len(slam.archived_kf)} vi_initialized={slam.vi_initialized} "
            f"ATE={rec['ate'] * 1e3:.3f} mm median frame {np.median(ms):.2f} ms (kf frames "
            f"included; first frame {ms[0]:.1f} ms), tracking frames median "
            f"{np.median(ms[~kf]):.2f} ms p90 {np.percentile(ms[~kf], 90):.2f} ms, run "
            f"{rec['run_s']:.1f} s, launches lk_track={rec['lk_track']} "
            f"lk_iterate={rec['lk_iterate']}")


def phase_main_path(world, frames, device):
    """The full-width main path on the fused engine: one lk_track launch
    per klt.track call and none of lk_iterate."""
    with _ClockSampler() as clocks:
        rec = run_slam(world, frames, device, "fused")
    slam = rec["slam"]
    print(f"main path: {_describe(rec)}")
    print(f"main path: {clocks.summary()}")
    _require(slam.vi_initialized, "VIInit never fired")
    _require(len(slam.archived_kf) >= 1, "the window never rolled")
    _require(bool(slam.priors.sp_mask.any()), "sparsified VIO prior missing")
    _require(rec["ate"] < ATE_TOL_M, f"ATE {rec['ate']:.4f} m")
    _require(rec["lk_track"] > 0, "the main path never launched the fused track kernel")
    _require(rec["lk_iterate"] == 0, "the fused engine launched the per-level kernel")
    _require(slam.n_resets == 0, "the main path reset")
    _require(rec["lk_track"] == _accounted_tracks(rec),
             f"{rec['lk_track']} lk_track launches for {_accounted_tracks(rec)} klt.track calls")
    _require(slam.window.R.is_cuda and slam.window.lmk.is_cuda and slam.obs.uv.is_cuda,
             "window state left the card")
    return rec


def _accounted_tracks(rec):
    """klt.track calls of a run without a reset: one frame track per frame
    after the first, one stereo track per keyframe."""
    return (rec["frames"] - 1) + int(rec["is_kf"].sum())


def phase_long_run(device, n_frames=LONG_FRAMES, seed=LONG_SEED):
    """The long-run path at full width: 752x480 stereo VIO, K=11, L=512,
    global map + pose graph + mesh on, over an excursion that returns to its
    start.  The new stages are timed as the run goes."""
    world, frames = make_long_world(device, n_frames, seed)
    cfg_kw = dict(global_map=True, pose_graph=True, mesh3d=True, archive_capacity=4096,
                  archive_max_nodes=24, max_length_tsh=2.0, zncc_tsh=0.5)
    with _TimedFunctions() as timed:
        rec = run_slam(world, frames, device, "fused", cfg_kw=cfg_kw,
                       capture_roll=LONG_CAPTURE_ROLL)
    slam, outs = rec["slam"], rec["outs"]
    res = sum(o.get("gm_resurrected", 0) for o in outs)
    lcs = [o["loop_closure"] for o in outs if "loop_closure" in o]
    long_lcs = [lc for lc in lcs if lc[1] - lc[0] > 1.0]
    tris = [o["mesh_triangles"] for o in outs if "mesh_triangles" in o]
    print(f"long run: {_describe(rec)}")
    print(f"long run: archived nodes {len(slam.archived_kf)} (cap {slam.cfg.archive_max_nodes}), "
          f"edges {len(slam.pose_graph_edges)}, archive landmarks "
          f"{int(slam.global_map_state.mask.sum())}, resurrections {res}, loop closures "
          f"{len(lcs)} ({len(long_lcs)} spanning more than 1 s), last closure try "
          f"(candidates, inliers, ok) {slam._lc_diag}")
    _require(slam.n_resets == 0, "the long run reset")
    _require(slam.vi_initialized, "VIInit never fired on the long run")
    n_rolls = sum(1 for o in outs if o.get("is_kf")) - slam.caps.K
    _require(n_rolls >= 10, f"the window rolled {n_rolls} times")
    _require(len(slam.archived_kf) >= 10, f"{len(slam.archived_kf)} archived keyframes")
    _require(res > 0, "no landmark was resurrected from the global map")
    _require(len(long_lcs) >= 1, f"no loop closure accepted: {lcs}")
    _require(rec["ate"] < ATE_TOL_M, f"long run ATE {rec['ate']:.4f} m")
    _require(rec["lk_track"] == _accounted_tracks(rec) and rec["lk_iterate"] == 0,
             f"{rec['lk_track']} lk_track launches for {_accounted_tracks(rec)} klt.track calls")

    # pose graph over archive + window: finite, and the newest node no worse
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nodes = slam.optimize_archive()
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t0) * 1e3
    # drift is read without a gauge: the position of each live-window node
    # relative to the oldest node (held fixed by the optimization), in that
    # node's body frame, against the same quantity of the ground truth
    gt_i = {float(f.ts): i for i, f in enumerate(frames)}
    node_t = {}
    for ts, _, t in nodes:
        node_t.setdefault(float(ts), np.asarray(t, np.float64))
    ts0, R_0, t_0 = nodes[0]
    i0 = gt_i[float(ts0)]

    def err(t, ts):
        i = gt_i[float(ts)]
        d_gt = world.gt_R[i0].T @ (world.gt_t[i] - world.gt_t[i0])
        return float(np.linalg.norm(np.asarray(R_0, np.float64).T @ (t - t_0) - d_gt))

    win = slam._window_poses()
    raw = [err(np.asarray(t, np.float64), ts) for ts, _, t in win]
    opt = [err(node_t[float(ts)], ts) for ts, _, _ in win]
    _require(all(np.isfinite(t).all() and np.isfinite(R).all() for _, R, t in nodes),
             "optimize_archive gave a non-finite node")
    print(f"long run: optimize_archive over {len(nodes)} nodes in {opt_ms:.1f} ms; newest node "
          f"error {raw[-1] * 1e3:.2f} mm raw, {opt[-1] * 1e3:.2f} mm optimized; window max "
          f"{max(raw) * 1e3:.2f} -> {max(opt) * 1e3:.2f} mm")
    _require(opt[-1] <= raw[-1] + 1e-4, "optimize_archive made the newest node worse")

    cloud = slam.mesher.dense_points()
    print(f"long run: mesh triangles per keyframe min/median/max {min(tris)}/"
          f"{int(np.median(tris))}/{max(tris)}, Delaunay triangles cut at the cap of "
          f"{slam.mesher.tri_cap}: {slam.mesher.n_cut} over {len(tris)} keyframes, dense cloud "
          f"{len(cloud)} points")
    _require(max(tris) > 0 and len(cloud) > 0, "the mesher produced nothing")
    gm = slam.global_map_state
    _require(all(x.is_cuda for x in (slam.window.lmk, gm.pos, gm.desc, slam.lmk_desc,
                                     slam.mesher.tri, slam.mesher.tri_mask,
                                     slam.mesher.cloud[-1][0])),
             "map, archive or mesh tensors left the card")
    for key, ms in timed.log.items():
        _require(len(ms) > 0, f"stage {key} never ran on the long run")
        print(f"long run: stage {key}: calls {len(ms)} mean {np.mean(ms):.3f} ms median "
              f"{np.median(ms):.3f} ms max {np.max(ms):.3f} ms")
    print(f"long run: stage optimize_archive: 1 call {opt_ms:.1f} ms ({len(nodes)} nodes, "
          f"{len(slam.pose_graph_edges)} edges)")
    _require(rec["captured"] is not None, f"VIO roll {LONG_CAPTURE_ROLL} never came")
    rec["timed"] = timed
    return rec


def phase_stage_kernels(long_rec):
    """Kernel counts and device time of the long run's new stages: the last
    call of each replayed under torch.profiler (the mesher's update as a
    whole holds its two stages and the host's Delaunay, which launches
    nothing), and optimize_archive on the run's final state."""
    calls = dict(long_rec["timed"].calls)
    calls.pop("mesh.delaunay_triangles")
    calls["optimize_archive"] = (long_rec["slam"].optimize_archive, (), {})
    for key, (fn, a, k) in calls.items():
        table, _ = _profile(lambda: fn(*a, **k), n=5)
        print(f"measure: stage {key}: {sum(c for c, _ in table.values()) / 5:.0f} kernels, "
              f"{sum(us for _, us in table.values()) / 5 / 1e3:.3f} ms of device time per call")


def phase_long_sweep(device):
    """The long run and its marginalization check at other lengths and
    seeds, to show how much of the result the one fixed setting carries.
    Requirements that fail here are printed and fail nothing."""
    global _require
    failed = []
    strict, _require = _require, lambda cond, msg: cond or failed.append(msg)
    try:
        for n_frames, seed in LONG_SWEEP:
            print(f"sweep: long run frames={n_frames} seed={seed}")
            phase_marg_backends(phase_long_run(device, n_frames, seed), device)
            print(f"sweep: frames={n_frames} seed={seed} requirements failed: {failed}")
            failed.clear()
    finally:
        _require = strict


def phase_frontends(world, frames, device, fused):
    """The matcher tracker (BRIEF match + a levels=1 lk_track polish per
    frame), then the epipolar pose estimator, on the first frames of the
    main path's world."""
    recs = {}
    for name, kw in (("matcher", dict(tracker="matcher")),
                     ("epipolar", dict(pose_estimator="epipolar"))):
        with _TimedFunctions((("detect", "brief_describe"),)) as timed:
            rec = run_slam(world, frames[:N_FRAMES_FRONTEND], device, "fused", cfg_kw=kw)
        by = rec["lk_track_by_levels"]
        print(f"{name} run: {_describe(rec)} by levels {by}")
        _require(rec["slam"].n_resets == 0, f"the {name} run reset")
        _require(rec["ate"] < ATE_TOL_M, f"{name} run ATE {rec['ate']:.4f} m")
        _require(rec["lk_track"] == _accounted_tracks(rec) and rec["lk_iterate"] == 0,
                 f"{name} run: {rec['lk_track']} launches for {_accounted_tracks(rec)} tracks")
        n_kf = int(rec["is_kf"].sum())
        if name == "matcher":
            _require(by.get(1, 0) == rec["frames"] - 1 and by.get(LEVELS, 0) == n_kf,
                     f"matcher run: launches by levels {by}")
            ms = timed.log["detect.brief_describe"]
            print(f"matcher run: stage detect.brief_describe: calls {len(ms)} median "
                  f"{np.median(ms):.3f} ms")
        else:
            _require(by.get(1, 0) == 0, "the epipolar run launched a levels=1 track")
            oks = [o["pnp_ok"] for o in rec["outs"] if "pnp_ok" in o]
            _require(np.mean(oks) > 0.8, f"essential RANSAC accepted {np.mean(oks):.2f}")
        gap = float(np.linalg.norm(rec["est"] - fused["est"][:N_FRAMES_FRONTEND], axis=1).max())
        print(f"{name} run: max position gap to the KLT + PnP run {gap * 1e3:.3f} mm")
        recs[name] = rec
    return recs


def _marg_products(state, rig, opts, device):
    """Every marginalization product of one window on `device`, float64 numpy."""
    from sadvio_tpu_torch.backend import marginalization as marg

    window, obs, imu, priors = [x.to(device) for x in state]
    rig = rig.to(device)
    info = lambda W: (W.double().transpose(-1, -2) @ W.double()).cpu().numpy()
    out, ms = {}, {}

    def timed(key, fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms[key] = (time.perf_counter() - t0) * 1e3
        return res

    for tag, f64 in (("f32", False), ("f64", True)):
        new, inf = timed(f"marginalize {tag}", lambda: marg.marginalize(
            window, obs, rig, imu, priors, opts, vio=True, sparsify=True, f64=f64))
        out[f"{tag} sp_info"] = info(new.sp_sqrt_info[1])
        out[f"{tag} plp_info"] = info(new.plp_sqrt_info)
        out[f"{tag} Ak"] = inf["Ak"].double().cpu().numpy()
        dense, _ = timed(f"dense replay {tag}", lambda: marg.marginalize(
            window, obs, rig, imu, priors, opts, vio=True, sparsify=False, f64=f64))
        out[f"{tag} dn_info"] = info(dense.dn_J)
        out[f"{tag} slots"] = new.prior_slots.cpu().numpy() * new.prior_slot_mask.cpu().numpy()
    dx, inf_e, n_sh = timed("marginalize_relative", lambda: marg.marginalize_relative(
        window, obs, rig, imu, opts, vio=True))
    out["nfr_dx"] = dx.double().cpu().numpy()
    out["nfr_info"] = inf_e.double().cpu().numpy()
    _require(int(n_sh) > 0, "the captured window shares no landmark between slots 0 and 1")
    return out, ms


def _one_ulp_off(state, seed, eps=6e-8):
    """The window with its landmarks, positions and pixel observations moved
    by half a float32 unit in the last place, at random."""
    gen = torch.Generator().manual_seed(seed)
    window, obs, imu, priors = state
    off = lambda x: x * (1 + eps * torch.randn(x.shape, generator=gen))
    return (window.replace(lmk=off(window.lmk), t=off(window.t)), obs.replace(uv=off(obs.uv)),
            imu, priors)


MARG_FLOOR_SEEDS = (1, 2, 3)
MARG_FLOOR_FACTOR = 10.0  # a gap this many times the rounding floor is the backend's
MARG_PHANTOM = 1e-2  # of the blanket scale: information made of noise, whatever the floor


def phase_marg_backends(long_rec, device):
    """cuSOLVER against LAPACK: the marginalization products of one window
    of the long run, on the card and on the CPU from the same state.

    Limits are scale-aware: a prior block's gap counts against the
    blanket's information scale |Ak| (1e-4); the relative edge's information
    against its own norm (0.15: two pseudo-inverses); every other product
    against its own norm (1e-3).  Some products are thresholded
    pseudo-inverses of near-singular matrices and move by more than their
    limit when the input moves by one float32 rounding, on any backend.  So
    each product's rounding floor is measured too: its largest gap on the CPU
    alone between the window and copies of it moved by half a unit in the last
    place.  A product over its limit fails the run when its gap is more than
    10 times that floor (the backend, not the rounding, made it) or when a
    prior block's gap reaches 1e-2 of the blanket scale (a phantom prior:
    blanket-scale information made of noise)."""
    slam = long_rec["slam"]
    state = [x.to("cpu") for x in long_rec["captured"]]
    cpu_dev = torch.device("cpu")
    for _ in range(2):  # the first pass on the card pays cuSOLVER's set-up
        gpu, ms_gpu = _marg_products(state, slam.rig, slam._ba_opts, device)
    cpu, ms_cpu = _marg_products(state, slam.rig, slam._ba_opts, cpu_dev)
    moved = [_marg_products(_one_ulp_off(state, seed), slam.rig, slam._ba_opts, cpu_dev)[0]
             for seed in MARG_FLOOR_SEEDS]
    for key in ms_gpu:
        print(f"marg backends: {key}: card {ms_gpu[key]:.1f} ms, CPU {ms_cpu[key]:.1f} ms")
    bad = []
    for key in gpu:
        a, b = gpu[key], cpu[key]
        if key.endswith("slots"):
            _require(np.array_equal(a, b), f"{key} differ between the card and the CPU")
            continue
        own = max(np.linalg.norm(b), 1e-20)
        prior_block = key.endswith(("sp_info", "plp_info"))
        if prior_block:
            scale, limit, what = max(np.linalg.norm(cpu[key[:3] + " Ak"]), 1e-20), 1e-4, "blanket"
        elif key == "nfr_info":
            scale, limit, what = own, 0.15, "own norm"
        else:
            scale, limit, what = own, 1e-3, "own norm"
        rel = float(np.linalg.norm(a - b) / scale)
        floor = max(float(np.linalg.norm(m[key] - b) / scale) for m in moved)
        if rel <= limit:
            verdict = ""
        elif rel <= MARG_FLOOR_FACTOR * floor and not (prior_block and rel >= MARG_PHANTOM):
            verdict = "  over the limit, at the rounding floor"
        else:
            verdict = "  <-- RED FLAG"
            bad.append(key)
        print(f"marg backends: {key:12s} |card| {np.linalg.norm(a):.5g} |cpu| {own:.5g} gap "
              f"{rel:.3e} vs {what} (limit {limit:g}; rounding floor on the CPU alone "
              f"{floor:.3e}){verdict}")
    _require(not bad, f"backend-dependent marginalization products: {bad}")


# ----------------------------------------------------------------------
# the monocular, non-overlapping-FoV and exotic-camera modes
# ----------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
MODE_CAPS = dict(L=512, P=48, pyr_levels=LEVELS, klt_radius=RADIUS)  # K from the preset
MONO_ATE_TOL_M = 0.08  # the Sim3 gate of the JAX package's mono tests
MONO_CAPTURE_CALL = 40  # the frame track (warped klt.track) whose inputs are replayed
# the main path's keyframe parallax: at the preset's 4 deg every keyframe of
# this world comes from the 1 s timer, 21 frames (1.05 s) apart, just over
# the 1 s gap past which the IMU factor is dropped; VIInit then has too few
# IMU pairs and the run degrades after it, in the JAX package as in the port
MONOVIO_MAX_PARALLAX = 1.0
NOFOV_FRAMES, NOFOV_SEED, NOFOV_POINTS = 60, 6, 400
NOFOV_SIZE, NOFOV_F, NOFOV_LEVER, NOFOV_ROT = (640, 480), 420.0, 1.5, 1.5
NOFOV_PERTURB_AFTER, NOFOV_PERTURB = 20, 1.4  # the JAX test's window-scale corruption
NOFOV_TAIL = 10
# the JAX test's keyframe parallax: at the preset's 3 deg a keyframe comes every ~15
# frames and one scale estimate is all a 60-frame run makes
NOFOV_MAX_PARALLAX = 0.5
EXOTIC_FRAMES = 60
EXOTIC_STEREO_ATE_TOL_M = 0.06  # tests/test_pipeline_stress.py's exotic-camera gate


def preset_config(name, **kw):
    """configs/<name>/config.yaml with the smoke capacities: K from its
    max_kf_number, L=512, P=48, 4 levels, radius 5."""
    import dataclasses

    from sadvio_tpu_torch.pipeline.config import Capacities, load_slam_config

    cfg = load_slam_config(os.path.join(REPO, "configs", name, "config.yaml"))
    return dataclasses.replace(cfg, caps=Capacities(K=cfg.max_kf_number + 1, **MODE_CAPS), **kw)


class _CaptureTrack:
    """Keep the arguments of the n-th warped klt.track call while a run goes
    (the pipeline modules call it through the module, so patching the
    attribute is enough; the original is put back on exit).  n=0 keeps
    none."""

    def __init__(self, n):
        self.n, self.count, self.args = n, 0, None

    def __enter__(self):
        from sadvio_tpu_torch.frontend import klt

        self.klt, self.orig = klt, klt.track

        def track(*a, **k):
            if k.get("warp") is not None:
                self.count += 1
                if self.count == self.n:
                    self.args = (a, dict(k))
            return self.orig(*a, **k)

        klt.track = track
        return self

    def __exit__(self, *exc):
        self.klt.track = self.orig


def _count_calls(slam, names):
    """Count calls of the pipeline's methods: {name: calls}, filled as the
    run goes."""
    counts = {n: 0 for n in names}

    def wrap(name, fn):
        def counted(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return counted

    for n in names:
        setattr(slam, n, wrap(n, getattr(slam, n)))
    return counts


def _drive_mode(slam, frames, after_frame=None):
    """Drive any pipeline over `frames`; launch counts set to 0 just before
    the first frame and read just after the last.  `after_frame(i, slam)`
    runs after frame i.  Returns the run's record."""
    from sadvio_tpu_torch.ops import klt_kernel

    klt_kernel.lk_iterate.launches = 0
    klt_kernel.lk_track.launches = 0
    klt_kernel.lk_track.launches_by_levels = {}
    outs, ms, i0 = [], [], None
    t_run = time.perf_counter()
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        outs.append(slam.process_frame(f))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i0 is None and slam.initialized:
            i0 = i
        if after_frame is not None:
            after_frame(i, slam)
    rec = {"slam": slam, "frames": len(frames), "run_s": time.perf_counter() - t_run,
           "frame_ms": np.asarray(ms), "outs": outs, "i0": i0,
           "is_kf": np.asarray([bool(o["is_kf"]) for o in outs]),
           "lk_track": klt_kernel.lk_track.launches, "lk_iterate": klt_kernel.lk_iterate.launches}
    est = np.asarray([t for _, _, t in slam.traj])
    _require(len(est) == len(frames), "one pose per frame expected")
    _require(np.isfinite(est).all() and all(np.isfinite(R).all() for _, R, _ in slam.traj),
             "non-finite pose")
    rec["est"] = est
    return rec


def _mode_summary(name, rec, extra=""):
    slam, ms, kf = rec["slam"], rec["frame_ms"], rec["is_kf"]
    print(f"{name}: frames {rec['frames']} bootstrap frame {rec['i0']} keyframes "
          f"{len(slam.kf_traj)} rolls {len(slam.archived_kf)} resets {slam.n_resets} median frame "
          f"{np.median(ms):.2f} ms (tracking frames {np.median(ms[~kf]):.2f} ms, keyframes "
          f"{np.median(ms[kf]):.1f} ms), run {rec['run_s']:.1f} s, launches "
          f"lk_track={rec['lk_track']} lk_iterate={rec['lk_iterate']}{extra}")


def _stage_summary(name, log):
    for key, ms in log.items():
        if ms:
            print(f"{name}: stage {key}: calls {len(ms)} mean {np.mean(ms):.2f} ms median "
                  f"{np.median(ms):.2f} ms max {np.max(ms):.2f} ms")


def run_mono(world, frames, device, preset, vio, capture=0, **cfg_kw):
    """MonoSLAM over camera 0 of `frames` with a preset's settings
    (`cfg_kw` overrides keys); the bootstrap, the window BA and VIInit are
    timed as the run goes.  Checks what every monocular run must hold; the
    caller gates the accuracy.  VIInit moves the window into a gravity-aligned
    metric gauge while the poses logged before it stay in the bootstrap's, so
    each of the two segments is aligned on its own: ate_sim3 is the larger
    Sim3 ATE of the two, ate_se3 and span_ratio are the metric segment's."""
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.mono import MonoSLAM

    slam = MonoSLAM(world.rig.subset([0]), preset_config(preset, **cfg_kw),
                    imu_params=world.imu_params if vio else None, device=device)
    stages = _time_stages(slam, ("_try_bootstrap", "_backend", "_run_vi_init"))
    with _CaptureTrack(capture) as cap:
        rec = _drive_mode(slam, [f._replace(images=f.images[:1]) for f in frames])
    rec["capture"], rec["stages"] = cap.args, stages
    i0, n = rec["i0"], rec["frames"]
    _require(i0 is not None, f"{preset}: the bootstrap never fired")
    iv = next((i for i, o in enumerate(rec["outs"]) if o.get("vi_initialized")), None)
    rec["vi_frame"] = iv if vio else None
    segs = [(i0, n)] if rec["vi_frame"] is None else [(i0, iv + 1), (iv + 1, n)]
    est, gt = rec["est"], world.gt_t[:n]
    rec["ate_segments"] = [synthetic.ate_rmse(est[a:b], gt[a:b], with_scale=True) for a, b in segs]
    rec["ate_sim3"] = max(rec["ate_segments"])
    a, b = segs[-1]
    rec["ate_se3"] = synthetic.ate_rmse(est[a:b], gt[a:b])
    rec["span_ratio"] = float(np.linalg.norm(est[b - 1] - est[a])
                              / np.linalg.norm(gt[b - 1] - gt[a]))
    _require(slam.n_resets == 0, f"{preset}: the run reset")
    # one klt.track per frame after the first: the bootstrap's track until
    # it fires, the frame track after it (no stereo track at a keyframe)
    _require(rec["lk_track"] == rec["frames"] - 1 and rec["lk_iterate"] == 0,
             f"{preset}: {rec['lk_track']} lk_track launches for {rec['frames'] - 1} tracks")
    _require(slam.window.R.is_cuda and slam.window.lmk.is_cuda, "window state left the card")
    return rec


def phase_mono(world, frames, device, vio):
    """Monocular VO ("euroc_mono") or VIO ("euroc_monovio") on camera 0 of
    the main path's world: the bootstrap fires, Sim3 ATE after it < 0.08 m;
    with the IMU, VIInit with scale fires and the metric span is within
    0.7-1.4 of the truth's.  The inputs of one frame track of the mono run
    are kept for the kernel check at that call shape."""
    if vio:
        preset, kw = "euroc_monovio", dict(max_movement_parallax=MONOVIO_MAX_PARALLAX)
        rec = run_mono(world, frames, device, preset, vio, **kw)
    else:
        preset = "euroc_mono"
        rec = run_mono(world, frames, device, preset, vio, capture=MONO_CAPTURE_CALL)
    slam = rec["slam"]
    _mode_summary(preset, rec, f" | Sim3 ATE {rec['ate_sim3'] * 1e3:.3f} mm (per gauge segment "
                  f"{[round(x * 1e3, 3) for x in rec['ate_segments']]}), SE3 ATE "
                  f"{rec['ate_se3'] * 1e3:.3f} mm and span ratio {rec['span_ratio']:.4f} "
                  f"(metric segment), VIInit at frame {rec['vi_frame']}")
    _stage_summary(preset, rec["stages"])
    _require(rec["ate_sim3"] < MONO_ATE_TOL_M, f"{preset}: Sim3 ATE {rec['ate_sim3']:.4f} m")
    if vio:
        _require(slam.vi_initialized, "monovio: VIInit never fired")
        _require(0.7 < rec["span_ratio"] < 1.4, f"monovio: span ratio {rec['span_ratio']:.3f}")
    else:
        _require(rec["capture"] is not None, "mono: the frame track to replay never came")
    return rec


def make_nofov_world(device, n_frames=NOFOV_FRAMES):
    from sadvio_tpu_torch.pipeline import synthetic

    world = synthetic.make_nofov_world(
        seed=NOFOV_SEED, n_frames=n_frames, width=NOFOV_SIZE[0], height=NOFOV_SIZE[1],
        n_points=NOFOV_POINTS, rot_scale=NOFOV_ROT, lever=NOFOV_LEVER, f=NOFOV_F, device=device)
    frames = [f._replace(images=np.clip(f.images, 0, 255).astype(np.uint8)) for f in world.frames]
    return world, frames


def _rotation_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def phase_nofov(device):
    """Non-overlapping FoV ("configs/nofov": 640x480, f=420, K=11, L=256+256,
    P=48, dense marginalization) on the scale-recovery world (lever 1.5 m,
    rot_scale 1.5) with the 1.4x window-scale corruption after frame 20:
    the gates of tests/test_nofov_pipeline.py's recovery test.  Every
    camera-1 re-track is recorded with its rotation; the widest one is kept
    for the kernel check at that call shape."""
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM

    world, frames = make_nofov_world(device)
    slam = NoFovSLAM(world.rig, preset_config("nofov", max_movement_parallax=NOFOV_MAX_PARALLAX),
                     device=device)
    calls = _count_calls(slam, ("_track_cam1",))
    stages = _time_stages(slam, ("_try_bootstrap", "_estimate_scale_window", "_backend"))
    refine = slam._track_cam1_refine
    retracks = []

    def recorded(pyr_a, pyr_b, uv_a, init, valid, R_1):
        retracks.append((_rotation_deg(R_1.cpu().numpy()), (pyr_a, pyr_b, uv_a, init, valid, R_1)))
        return refine(pyr_a, pyr_b, uv_a, init, valid, R_1)

    slam._track_cam1_refine = recorded
    perturbed = []

    def perturb(i, s):
        if not perturbed and s.scale_state["applied"] and i >= NOFOV_PERTURB_AFTER:
            s._apply_scale_window(NOFOV_PERTURB)
            perturbed.append(i)

    rec = _drive_mode(slam, frames, after_frame=perturb)
    i0, outs, L = rec["i0"], rec["outs"], slam.caps.L
    _require(i0 is not None, "nofov: the bootstrap never fired")
    est, gt = rec["est"][i0:], world.gt_t[i0: rec["frames"]]
    shape_ate = synthetic.ate_rmse(est, gt, with_scale=True)
    metric_ate = synthetic.ate_rmse(est, gt)
    seg = lambda p: np.linalg.norm(np.diff(p[-NOFOV_TAIL:], axis=0), axis=-1).sum()
    tail = float(seg(rec["est"]) / max(seg(world.gt_t[: rec["frames"]]), 1e-9))
    n_cam1 = int(slam.window.lmk_mask[L // 2:].sum())
    applied = [o["scale_applied"] for o in outs if "scale_applied" in o]
    ratios = [round(o["scale_ratio"], 5) for o in outs if "scale_ratio" in o]
    n_chain, n_re = calls["_track_cam1"], len(retracks)
    angles = [a for a, _ in retracks] or [0.0]
    _mode_summary("nofov", rec, f" = {rec['frames'] - 1} bootstrap/frame tracks + {n_chain} "
                  f"chained camera-1 tracks + {n_re} warped re-tracks")
    print(f"nofov: scale_applied {applied} (perturbed x{NOFOV_PERTURB} after frame "
          f"{perturbed}), scale_ratio per keyframe {ratios}, estimates "
          f"{slam.scale_state['n_est']}, final s {slam.scale_state['s']:.5f}, camera-1 landmarks "
          f"{n_cam1}, tail segment scale {tail:.4f}, shape (Sim3) ATE {shape_ate * 1e3:.3f} mm, "
          f"metric (SE3) ATE {metric_ate * 1e3:.3f} mm, re-track rotations min/median/max "
          f"{min(angles):.2f}/{np.median(angles):.2f}/{max(angles):.2f} deg")
    _stage_summary("nofov", stages)
    _require(slam.initialized and slam.scale_state["applied"], "nofov: scale never applied")
    _require(bool(perturbed), "nofov: the scale was not applied by the perturbation frame")
    _require(slam.scale_state["n_est"] >= 2, "nofov: continuous estimation inactive")
    _require(n_cam1 > 20, f"nofov: {n_cam1} camera-1 landmarks")
    _require(0.75 < tail < 1.3, f"nofov: tail scale {tail:.3f} did not recover")
    _require(slam.n_resets == 0, "nofov: the run reset")
    _require(rec["lk_track"] == rec["frames"] - 1 + n_chain + n_re and rec["lk_iterate"] == 0,
             f"nofov: {rec['lk_track']} lk_track launches for "
             f"{rec['frames'] - 1 + n_chain + n_re} tracks")
    _require(n_re > 0, "nofov: no warped re-track ran")
    rec.update(retrack=max(retracks, key=lambda r: r[0]), n_chain=n_chain, n_retrack=n_re,
               tail=tail, applied=applied, ratios=ratios, stages=stages,
               shape_ate=shape_ate, metric_ate=metric_ate)
    return rec


def phase_exotic(device):
    """The exotic camera models with the angular window BA at 752x480:
    "sim_omni_mono" (omni, mono), "sim_ds_monovio" (double sphere, monovio)
    and a fisheye stereo VO run with optimizer angular (as
    tests/test_pipeline_stress.py's exotic test), each on its camera's
    render of the main path's world, gated on its JAX counterpart's ATE."""
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    recs = {}
    for name, camera, preset, vio in (("sim_omni_mono", "omni", "sim_omni_mono", False),
                                      ("sim_ds_monovio", "double_sphere", "sim_ds_monovio", True),
                                      ("fisheye_bimono", "fisheye", None, False)):
        world, frames = make_world(device, EXOTIC_FRAMES, camera=camera)
        if preset is not None:
            rec = run_mono(world, frames, device, preset, vio)
            ok = rec["ate_sim3"] < MONO_ATE_TOL_M
            extra = (f" | Sim3 ATE {rec['ate_sim3'] * 1e3:.3f} mm, SE3 ATE "
                     f"{rec['ate_se3'] * 1e3:.3f} mm, VIInit at frame {rec['vi_frame']}")
        else:
            cfg = SLAMConfig(slam_mode="bimono", optimizer="angular", max_kf_number=10,
                             min_lmk_number=40, max_movement_parallax=1.0,
                             min_movement_parallax=0.02, caps=Capacities(**MAIN_CAPS))
            slam = StereoSLAM(world.rig, cfg, device=device)
            stages = _time_stages(slam, ("_backend",))
            rec = _drive_mode(slam, frames)
            rec["stages"] = stages
            rec["ate"] = synthetic.ate_rmse(rec["est"], world.gt_t[: rec["frames"]])
            ok = rec["ate"] < EXOTIC_STEREO_ATE_TOL_M
            extra = f" | ATE {rec['ate'] * 1e3:.3f} mm"
            _require(slam.n_resets == 0, f"{name}: the run reset")
            _require(rec["lk_track"] == rec["frames"] - 1 + int(rec["is_kf"].sum())
                     and rec["lk_iterate"] == 0, f"{name}: {rec['lk_track']} lk_track launches")
        slam = rec["slam"]
        _require(slam._ba_opts.angular, f"{name}: the angular BA is off")
        _mode_summary(f"exotic {name} ({type(slam.rig.cam).__name__})", rec, extra)
        _stage_summary(f"exotic {name}", rec["stages"])
        _require(ok, f"{name}: ATE over its gate")
        recs[name] = rec
    return recs


def phase_mono_kernel(mono):
    """lk_track against lk_track_ref at the mono frame track (752x480, one
    camera), on the inputs the mono run gave its 40th frame track."""
    (pyr0, pyr1, uv0, init, valid0), kw = mono["capture"]
    return _track_kernel_row("mono frame", pyr0, pyr1, uv0.contiguous(), init.contiguous(),
                             valid0.contiguous(), kw["warp"].contiguous(), 1, LEVELS,
                             profiler_required=False)


def phase_nofov_kernel(nofov):
    """lk_track against lk_track_ref at nofov's warped re-track (640x480,
    camera-1 slots only): the widest camera-1 rotation of the run, with the
    warp as the pipeline builds it."""
    from sadvio_tpu_torch.pipeline.nofov_mode import rotation_warp

    angle, (pyr_a, pyr_b, uv_a, init, valid, R_1) = nofov["retrack"]
    warp = rotation_warp(nofov["slam"].rig.cam.camera(1), R_1, init)
    print(f"kernel lk_track: nofov re-track input: camera-1 rotation {angle:.2f} deg, "
          f"{int(valid.sum())} common camera-1 tracks")
    row = _track_kernel_row("nofov re-track", pyr_a, pyr_b, uv_a.contiguous(), init.contiguous(),
                            valid.contiguous(), warp.contiguous(), 1, LEVELS,
                            profiler_required=False)
    row["rotation_deg"] = angle
    return row


def phase_levels_path(world, frames, device, fused):
    """The earlier path: the first frames again with one lk_iterate launch
    per level, held against the fused run's positions."""
    rec = run_slam(world, frames[:N_FRAMES_LEVELS], device, "levels")
    print(f"levels path: {_describe(rec)}")
    _require(rec["lk_iterate"] > 0, "the levels engine never launched lk_iterate")
    _require(rec["lk_track"] == 0, "the levels engine launched the fused kernel")
    gap = float(np.linalg.norm(rec["est"] - fused["est"][:N_FRAMES_LEVELS], axis=1).max())
    print(f"levels path: max position gap to the fused run {gap * 1e3:.3f} mm over "
          f"{N_FRAMES_LEVELS} frames")
    _require(gap < ENGINES_POS_TOL_M, f"engines disagree by {gap:.4f} m")
    return rec


def phase_parent(parent_dir, frame, device):
    """lk_iterate of another checkout of this repository (unpacked under
    `parent_dir`) against this one's, on the same inputs, in turns."""
    import importlib.util
    from pathlib import Path

    from sadvio_tpu_torch.ops import klt_kernel

    spec = importlib.util.spec_from_file_location(
        "parent_klt_kernel", Path(parent_dir) / "sadvio_tpu_torch" / "ops" / "klt_kernel.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    print(f"parent: built {parent.build()['path'].name}")
    for lvl, img1, uv, T, gx, gy, nrm, _, iters in _iterate_inputs(frame, device):
        run_p = lambda: parent.lk_iterate(img1, uv, T, gx, gy, nrm, iters=iters)
        run_c = lambda: klt_kernel.lk_iterate(img1, uv, T, gx, gy, nrm, iters=iters)
        _require(torch.equal(torch.isnan(run_p()), torch.isnan(run_c())), "NaN pattern differs")
        ms = [_graph_ms(run_p), _graph_ms(run_c), _graph_ms(run_c), _graph_ms(run_p)]
        print(f"parent: lk_iterate level {lvl} device ms (graph of {GRAPH_LAUNCHES}), in turns "
              f"parent {ms[0]:.5f}, this {ms[1]:.5f}, this {ms[2]:.5f}, parent {ms[3]:.5f}")


def phase_clocks(frames, device):
    """Where lk_track spends its cycles, by the counters of the library
    built with -DLK_CLOCKS (the card's machine has no kernel profiler)."""
    from sadvio_tpu_torch.ops import klt_kernel

    print(f"clocks: built {klt_kernel.build(clocks=True)['path'].name}")
    for shape in ("frame", "stereo"):
        pyr0, pyr1, uv0, init, valid0, warp, bwd = _track_inputs(frames, device, shape)
        kw = dict(levels=LEVELS, radius=RADIUS, iters=ITERS, iters_coarse=ITERS_COARSE,
                  bwd_levels=bwd)
        klt_kernel.lk_track_clocks(pyr0, pyr1, uv0, init, valid0, warp, **kw)  # warm
        ck = klt_kernel.lk_track_clocks(pyr0, pyr1, uv0, init, valid0, warp, **kw).numpy()
        total = ck[:, 3].mean()
        for i, name in enumerate(klt_kernel.CLOCK_FIELDS):
            col = ck[:, i]
            share = f" ({100 * col.mean() / total:.0f}% of the kernel)" if i < 3 else ""
            print(f"clocks: {shape} track {name}: mean {col.mean():.0f} median "
                  f"{np.median(col):.0f} max {col.max()} per feature{share}")


def phase_measure(world, frames, device):
    """End-to-end comparison of the two engines in turns on the one card
    (levels, fused, fused, levels), the stage tables, and the kernel count
    and device time of tracking frames 87-95 by torch.profiler for both
    engines."""
    for engine in ("levels", "fused", "fused", "levels"):
        print(f"measure: {_describe(run_slam(world, frames, device, engine))}")
    for engine in ("levels", "fused"):
        rec = run_slam(world, frames[:100], device, engine, profile_frames=(87, 95))
        p = rec["profile"]
        print(f"measure: engine={engine} tracking frames 87-95 under torch.profiler: "
              f"{p['kernels_per_frame']:.0f} kernels and {p['device_ms_per_frame']:.3f} ms of "
              f"device time per frame ({p['lk_ms_per_frame']:.4f} ms in the LK kernels), "
              f"{p['wall_ms_per_frame']:.1f} ms of wall per frame with the profiler on")
    for engine in ("levels", "fused"):
        rec = run_slam(world, frames, device, engine, stages=True)
        for name, ms in rec["stages"].items():
            if ms:
                print(f"measure: engine={engine} stage {name}: calls {len(ms)} mean "
                      f"{np.mean(ms):.2f} ms median {np.median(ms):.2f} ms")


SHAPE_KEYS = ("ms", "profiler_ms", "host_us", "plain_ms", "bound_ms", "bound_by", "max_abs_err_uv",
              "max_abs_err_err")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import sadvio_tpu_torch  # noqa: F401  (pins full fp32)

    measure = "--measure" in sys.argv[1:]
    device = torch.device("cuda")
    card = phase_env()
    phase_build()
    world, frames = make_world(device, N_FRAMES)
    it_rows = phase_kernel(frames[0], device)
    tr_rows = phase_track_kernel(frames, device)
    fused = phase_main_path(world, frames, device)
    levels = phase_levels_path(world, frames, device, fused)
    fronts = phase_frontends(world, frames, device, fused)
    long_rec = phase_long_run(device)
    phase_marg_backends(long_rec, device)
    mono = phase_mono(world, frames, device, vio=False)
    mode_rows = {"mono_frame": phase_mono_kernel(mono)}
    monovio = phase_mono(world, frames, device, vio=True)
    nofov = phase_nofov(device)
    mode_rows["nofov_refine"] = phase_nofov_kernel(nofov)
    exotic = phase_exotic(device)
    if measure:
        phase_stage_kernels(long_rec)
        phase_clocks(frames, device)
        phase_measure(world, frames, device)
    if "--sweep" in sys.argv[1:]:
        phase_long_sweep(device)
    if "--parent" in sys.argv[1:]:
        phase_parent(sys.argv[sys.argv.index("--parent") + 1], frames[0], device)
    print("library_ms: null for both kernels -- no single PyTorch call computes an LK "
          "iteration loop or a pyramidal forward-backward track")
    print(card)
    lvl0, tr, polish = it_rows[0], tr_rows[0], tr_rows[2]
    print(json.dumps({"kernels": [{
        "name": "lk_iterate", "route": "cuda",
        "source": "sadvio_tpu_torch/ops/csrc/lk_iterate.cu",
        "replaces": "sadvio_tpu/ops/klt_kernel.py:47",
        "launches": levels["lk_iterate"],
        "launches_per_frame": levels["lk_iterate"] / levels["frames"],
        "max_abs_err": max(max(r["max_abs_err_uv"], r["max_abs_err_err"]) for r in it_rows),
        "ms": lvl0["ms"], "profiler_ms": lvl0["profiler_ms"], "host_us": lvl0["host_us"],
        "plain_ms": lvl0["plain_ms"], "bound_ms": lvl0["bound_ms"],
        "bound_by": lvl0["bound_by"], "library_ms": None,
    }, {
        "name": "lk_track", "route": "cuda",
        "source": "sadvio_tpu_torch/ops/csrc/lk_track.cu",
        "replaces": "sadvio_tpu/ops/klt_kernel.py:47",
        "launches": fused["lk_track"],
        "launches_per_frame": fused["lk_track"] / fused["frames"],
        "max_abs_err": max(max(r["max_abs_err_uv"], r["max_abs_err_err"])
                           for r in (*tr_rows, *mode_rows.values())),
        "ms": tr["ms"], "profiler_ms": tr["profiler_ms"], "host_us": tr["host_us"],
        "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None,
        "launches_long_run": long_rec["lk_track"],
        "launches_matcher_run": fronts["matcher"]["lk_track_by_levels"],
        "levels1": {k: polish[k] for k in SHAPE_KEYS},
        "launches_mono_run": mono["lk_track"], "launches_monovio_run": monovio["lk_track"],
        "launches_nofov_run": {"total": nofov["lk_track"], "frame": nofov["frames"] - 1,
                               "chained": nofov["n_chain"], "retrack": nofov["n_retrack"]},
        "launches_exotic_runs": {k: r["lk_track"] for k, r in exotic.items()},
        "mono_frame": {k: mode_rows["mono_frame"][k] for k in SHAPE_KEYS},
        "nofov_refine": {k: mode_rows["nofov_refine"][k]
                         for k in (*SHAPE_KEYS, "rotation_deg")},
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
