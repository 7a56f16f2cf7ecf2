#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the LK kernels from
the sources in this checkout, checks each against its plain PyTorch version
at the main path's shapes, then drives the flagship stereo-VIO main path
(``StereoSLAM(rig, cfg, imu_params).run``) at EuRoC shapes, the long-run
path (global map, pose graph with loop closure, mesh) on a revisit world,
the matcher / epipolar front end, the monocular modes (``MonoSLAM``), the
non-overlapping-FoV mode (``NoFovSLAM``), the exotic camera models with the
angular BA and the typed feature channels (lines in the window BA, edgelets,
coded ellipse patterns, provider boxes, csv keypoints), and checks each
against ground truth.

    python3 chip_smoke.py             # the whole check
    python3 chip_smoke.py --measure   # adds lk_track's cycles per phase, the
                                      # end-to-end comparison of the two KLT
                                      # engines, the stage tables, the
                                      # kernels-per-frame count, the kernel
                                      # counts of the long-run stages and the
                                      # entry point's frame ms with the image
                                      # prefetch on and off
    python3 chip_smoke.py --sweep     # adds the long run at other lengths
                                      # and seeds, failures printed only
    python3 chip_smoke.py --parent DIR  # adds lk_iterate of the checkout
                                        # unpacked under DIR, timed in turns
    python3 chip_smoke.py --save-vi-init FILE.npz  # also writes the biased
                                        # run's accepted VIInit arguments
                                        # (tests/data/card_bias_vi_init.npz)

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
40 frames each); the typed channels: configs/euroc_bimonovio_full
(multithreading off, keyframe parallax 1.0 deg) with lines in the window BA
at 752x480 over the main world with 12 bright 3D segments, the starved line
world of tests/test_line_e2e.py with and without lines over five RANSAC
seeds, ``detect_lines`` twice on one frame (bit-equal), device profiles of
``detect_lines`` and of the standalone line refinement; edgelet,
coded-ellipse, provider-box and csv-keypoint runs of 40 frames each; ORB,
BRISK and DoH on the card against the CPU; the EuRoC entry point: the main
world written as a EuRoC sequence (uint8 PNGs, nanosecond stamps,
imu0/data.csv, its dataset.yaml) and replayed by
``sadvio_tpu_torch.run_euroc`` with configs/euroc_bimonovio at the main
path's keys and capacities (ATE of results.csv, VIInit, vio_poses.csv,
slam_profiler.txt, lk_track launches), a second run that saves a
checkpoint at frame 65 and a fresh instance resumed from it (held to the
gap between the two uninterrupted runs, at least 1e-6 m), configs/
euroc_bimonovio_full for 40 frames with multithreading on and off (CLAHE
through the loader), and clahe and remap on the card against the CPU; the
parallel modules: the associative preintegration against the sequential
one at N=10 and N=200, the main path's last 8 window BAs batched by vmap
against 8 separate solves, and two ranks sharing the card (gloo over CUDA
tensors) running the landmark-sharded BA and the time-sharded
preintegration against the single-device ones; the main path's 130 frames
with async_health off, on, on, off; typed labels in the mono class (only
the ellipse channel builds, a coded pattern stamped) and in the nofov class
(all four channels), 40 frames each; the biased world (the main world
with rot_scale 4 and tests/test_pipeline_stress.py's IMU biases, 130
frames: VIInit, ATE and both bias errors under the JAX test's gates) and
the hardened world (pixel noise, exposure flicker, the occluder, 80
frames: no reset, ATE; the share of live features each KLT gate rejects
per frame track), then ``lk_track`` against ``lk_track_ref`` at the
hardened run's frame track with the largest exposure step over the
occluder.
After every phase a probe asks whether ``torch.profiler`` still records an
``lk_track`` launch.  No phase catches its own failure.

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

import contextlib
import dataclasses
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
N_FRAMES_FRONTEND = 20  # the matcher and the epipolar runs (30 before the EuRoC phase came in)
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


def _profile(fn, n=1):
    """Device activity of n calls of fn by torch.profiler: ({kernel name:
    (count, self device us)}, wall seconds).  The profiler gates nothing:
    within one process it may stop recording device activity after a few
    sessions, at a point that differs between calls (PERF.md §6), so a
    profile without device time is reported and returned empty, and the
    caller keeps its CUDA-event times or profiles again in a fresh process
    (_fresh_process_profile_ms)."""
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
    if not out:
        print(f"profiler: {msg}")
    return out, wall


def _kernel_self_ms(table, name, calls, launches=None):
    """Self device ms per call of the kernels whose name contains `name`;
    None for an empty table (the profiler recorded no device time), and for
    a table that holds fewer than the `launches` expected (it recorded part
    of them)."""
    if not table:
        return None
    hit = [(c, us) for k, (c, us) in table.items() if name in k]
    seen = sum(c for c, _ in hit)
    if not hit or (launches is not None and seen != launches):
        expected = "" if launches is None else f" of {launches}"
        print(f"profiler: {seen}{expected} {name} launches recorded: a partial profile")
        return None
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


def _finite_slots(*uvs):
    return int(torch.stack([torch.isfinite(u).all(1) for u in uvs]).all(0).sum())


def bound_lk_iterate(img1, uv, T, gx, gy, nrm, iters):
    """Of the image, the (S+1)^2 pixels a bilinear S x S sample touches
    around each slot with a finite start (never more than the image holds);
    every other input read once, the (N,3) output written once; operations
    at the iteration cap (an upper bound on what the data needs: the bound
    is bytes even so)."""
    N, S = T.shape[0], T.shape[1]
    window = min(_finite_slots(uv) * (S + 1) ** 2 * 4, _nbytes(img1))
    return _bound(window + _nbytes(uv, T, gx, gy, nrm) + N * 3 * 4,
                  N * S * S * FLOP_PER_PIXEL_ITER * (iters + 1))


def bound_lk_track(pyr0, pyr1, uv0, uv_init, valid0, warp, bwd_levels, levels=LEVELS):
    """The answer is read only where valid0 holds (every other slot comes
    back invalid), so of the images it must read, for each live slot at
    each level, the (S+2)^2 halo its template is built from and the (S+1)^2
    pixels a bilinear S x S sample touches in the other pyramid (the
    backward pass revisits the same neighbourhoods), never more than the
    levels hold; every per-slot input is read once and (uv, valid, err)
    written once.  Operations of those slots at the iteration cap.
    "bound_tracked_ms" is the same bound over every slot whose two starts
    are finite: lk_track iterates those too, as the JAX kernel does.
    """
    N, S = uv0.shape[0], 2 * RADIUS + 1
    tracked = _finite_slots(uv0, uv_init)
    slots = [uv0, uv_init, valid0] + ([] if warp is None else [warp])
    passes = [ITERS if lvl == 0 else ITERS_COARSE for lvl in range(levels)]
    passes += [ITERS_COARSE] * bwd_levels
    per_slot_flop = sum((S + 2) ** 2 * FLOP_PER_HALO_PIXEL + S * S * FLOP_PER_TEMPLATE_PIXEL
                        + S * S * FLOP_PER_PIXEL_ITER * (it + 1) for it in passes)
    images = _nbytes(*pyr0[:levels], *pyr1[:levels])

    def bound(n):
        windows = min(n * levels * ((S + 2) ** 2 + (S + 1) ** 2) * 4, images)
        return _bound(windows + _nbytes(*slots) + N * (2 * 4 + 1 + 4), n * per_slot_flop)

    live = int(valid0.sum())
    return {**bound(live), "live": live, "tracked": tracked,
            "bound_tracked_ms": bound(tracked)["bound_ms"]}


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
        prof_ms = _kernel_self_ms(table, "lk_iterate_kernel", 20, 20)
        if prof_ms is None:
            prof_ms = _fresh_process_profile_ms(f"lk_iterate level {lvl}", "lk_iterate",
                                                (img1, uv, T, gx, gy, nrm), {"iters": iters}, 20)
        row = {"level": lvl, "H": img1.shape[0], "W": img1.shape[1], "iters": iters,
               "good": int(g.sum()), "max_abs_err_uv": d_uv, "max_abs_err_err": d_err,
               "ms": float(np.mean(ms_graph)), "profiler_ms": prof_ms,
               "one_launch_ms": _loop_ms(run_k, n=1, warmup=3),
               "host_us": _host_us(run_k), "plain_ms": float(np.mean(ms_r)),
               **bound_lk_iterate(img1, uv, T, gx, gy, nrm, iters)}
        rows.append(row)
        print(f"kernel lk_iterate: level {lvl} {row['H']}x{row['W']} N={N_FEATURES} "
              f"S={2 * RADIUS + 1} iters={iters} good={row['good']} "
              f"max|duv|={d_uv:.3e} px max|derr|={d_err:.3e} | device {row['ms']:.5f} ms "
              f"(graph of {GRAPH_LAUNCHES}) profiler self {_ms(row['profiler_ms'])}, "
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


def _track_kernel_row(shape, pyr0, pyr1, uv0, init, valid0, warp, bwd, levels, under=None):
    """One call shape of lk_track: held against lk_track_ref and the
    five-launch engine="levels" track (NaN rows equal, `valid` equal away
    from a gate tie, positions within UV_TOL_PX on features valid in both;
    how many of those differ in any bit, and by how many float32 units in
    the last place at most, is printed), then timed in turns.  Where the
    profile records none or part of the launches, lk_track's profiler time
    is taken in a fresh process and the levels engine's profiler figures
    are "not measured" (the CUDA-event times stay).  `under` (a mask of
    features) prints how many of them each of lk_track and lk_track_ref
    leaves valid."""
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
    if under is not None:
        print(f"kernel lk_track: {shape}: of the {int(under.sum())} live features that start "
              f"under the occluder valid {int((out_k[1] & under).sum())} (lk_track) / "
              f"{int((out_r[1] & under).sum())} (lk_track_ref)")
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
    tab_k, _ = _profile(run_k, n=n_prof)
    tab_l, _ = _profile(run_l, n=n_prof)
    row = {"shape": shape, "max_abs_err_uv": worst["uv"], "max_abs_err_err": worst["err"],
           "ms": float(np.mean(ms_k)),
           "profiler_ms": _kernel_self_ms(tab_k, "lk_track_kernel", n_prof, n_prof),
           "python_loop_ms": _loop_ms(run_k), "host_us": _host_us(run_k),
           "plain_ms": float(np.mean(ms_r)),
           "levels_python_loop_ms": float(np.mean(ms_l)),
           "levels_device_ms": (sum(us for _, us in tab_l.values()) / n_prof / 1e3
                                if tab_l else None),
           "levels_lk_iterate_device_ms": _kernel_self_ms(tab_l, "lk_iterate_kernel", n_prof),
           "levels_kernels": sum(c for c, _ in tab_l.values()) / n_prof if tab_l else None,
           "levels_host_us": _host_us(run_l, n=20),
           **bound_lk_track(pyr0, pyr1, uv0, init, valid0, warp, bwd, levels)}
    if row["profiler_ms"] is None:
        row["profiler_ms"] = _fresh_process_profile_ms(
            f"{shape} track", "lk_track", (pyr0, pyr1, uv0, init, valid0, warp), kw, n_prof)
    H, W = pyr0[0].shape
    print(f"kernel lk_track: {shape} track {H}x{W} N={N} S={2 * RADIUS + 1} levels={levels} "
          f"| fused: device {row['ms']:.5f} ms (graph of {GRAPH_LAUNCHES}), profiler self "
          f"{_ms(row['profiler_ms'])}, as Python launches it {row['python_loop_ms']:.4f} ms, "
          f"host {row['host_us']:.1f} us/call | engine=levels: "
          f"{'not measured' if row['levels_kernels'] is None else row['levels_kernels']} "
          f"kernels, device {_ms(row['levels_device_ms'], 4)} (profiler, all kernels; "
          f"lk_iterate alone {_ms(row['levels_lk_iterate_device_ms'])}), as Python launches "
          f"it {row['levels_python_loop_ms']:.3f} ms, host {row['levels_host_us']:.0f} us/call "
          f"| plain {row['plain_ms']:.2f} ms | bound {row['bound_ms']:.5f} ms by "
          f"{row['bound_by']} ({row['bytes']} B, {row['flop']} FLOP at the cap; the windows of "
          f"the {row['live']} live slots; of the {row['tracked']} tracked ones "
          f"{row['bound_tracked_ms']:.5f} ms)")
    return row


PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".smoke_profile")


def _fresh_process_profile_ms(label, kernel, args, kw, n):
    """The profiler self time per call of klt_kernel.<kernel>(*args, **kw),
    taken in a new interpreter on the same inputs (saved under the
    git-ignored .smoke_profile/, removed after): ms, or None if that
    profile records no device time either.  An argument is a tensor, a
    tuple of tensors (a pyramid) or None."""
    import shutil

    cpu = lambda a: (None if a is None else [t.cpu() for t in a] if isinstance(a, (tuple, list))
                     else a.cpu())
    os.makedirs(PROFILE_DIR, exist_ok=True)
    path = os.path.join(PROFILE_DIR, f"{label.replace(' ', '_')}.pt")
    torch.save({"kernel": kernel, "args": [cpu(a) for a in args], "kw": kw, "n": n}, path)
    try:
        proc = subprocess.run([sys.executable, "-c", f"import chip_smoke as c; "
                               f"c._profile_saved({path!r})"], cwd=REPO, capture_output=True,
                              text=True, timeout=300)
    finally:
        shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    _require(proc.returncode == 0, f"fresh-process profile of {label}: {proc.stderr[-2000:]}")
    ms = json.loads(proc.stdout.strip().splitlines()[-1])["profiler_ms"]
    print(f"kernel {kernel}: {label} profiled in a fresh process: self {_ms(ms)} per call "
          f"({n} calls)")
    return ms


def _profile_saved(path):
    """Entry of the fresh process: profile n calls of the saved kernel on
    the saved inputs; prints {"profiler_ms": ...} as its last line."""
    import sadvio_tpu_torch  # noqa: F401  (pins full fp32)
    from sadvio_tpu_torch.ops import klt_kernel

    d = torch.load(path)
    dev = torch.device("cuda")
    to = lambda a: (None if a is None else tuple(t.to(dev) for t in a) if isinstance(a, list)
                    else a.to(dev))
    args = [to(a) for a in d["args"]]
    fn = getattr(klt_kernel, d["kernel"])
    tab, _ = _profile(lambda: fn(*args, **d["kw"]), n=d["n"])
    print(json.dumps({"profiler_ms": _kernel_self_ms(tab, f"{d['kernel']}_kernel", d["n"],
                                                     d["n"])}))


MAIN_CAPS = dict(K=11, L=512, P=48, pyr_levels=LEVELS, klt_radius=RADIUS)
STAGES = ("_pyramids", "_accumulate_imu", "_frontend", "_insert_kf", "_template_cache",
          "_backend", "_marg_roll", "_run_vi_init")


def _time_stages(slam, names=STAGES, sync=True):
    """Wrap the pipeline's stages with a host clock, synchronised before and
    after each call (or, with ``sync=False``, the host's own time in the
    call: what it takes to launch the stage); returns {stage: [ms, ...]}
    filled as the run goes."""
    log = {name: [] for name in names}
    wait = torch.cuda.synchronize if sync else (lambda: None)

    def wrap(name, fn):
        def timed(*a, **k):
            wait()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            wait()
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
    patching the attribute is enough; the originals are put back on exit.
    A call made while a stage is being captured into a CUDA graph is not
    timed (it runs nothing then, and a sync would break the capture), and
    the graph's replays do not call it: inside a captured stage only the
    eager calls, one per variant, are timed."""

    def __init__(self, names=LONG_STAGES):
        from sadvio_tpu_torch.backend import marginalization as marg
        from sadvio_tpu_torch.data import globalmap as gmap
        from sadvio_tpu_torch.frontend import detect, ellipses, lines
        from sadvio_tpu_torch.mesh import mesh

        mods = dict(detect=detect, gmap=gmap, marg=marg, mesh=mesh, lines=lines,
                    ellipses=ellipses)
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
            if torch.cuda.is_current_stream_capturing():
                return orig(*a, **k)
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


def main_slam(world, device, caps=MAIN_CAPS, cfg_kw=None):
    """The main path's StereoSLAM on `world` (`cfg_kw` overrides config keys)."""
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    cfg = SLAMConfig(slam_mode="bimonovio", max_kf_number=10, min_lmk_number=40,
                     max_movement_parallax=1.0, min_movement_parallax=0.02,
                     async_health=False, caps=Capacities(**caps), **(cfg_kw or {}))
    return StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device=device)


def run_slam(world, frames, device, engine, caps=MAIN_CAPS, stages=False, profile_frames=(),
             cfg_kw=None, capture_roll=None, capture_ba=0, eager=False, stage_host=False):
    """Drive StereoSLAM over `frames` on `engine`; returns the run's record.
    Launch counts are set to 0 just before the first frame and read just
    after the last.  `profile_frames` (first, last) puts torch.profiler
    around those frames.  `cfg_kw` overrides config keys.  `capture_roll`
    keeps a copy of what the n-th VIO window roll was given; `capture_ba`
    keeps the BAProblems of the last n window BAs (`_backend` calls).
    `eager` runs the stages plainly (graphs.eager()) instead of replaying
    their captured graphs; `stage_host` logs the host's ms in each captured
    stage's calls (no synchronisation)."""
    from sadvio_tpu_torch.models import imu
    from sadvio_tpu_torch.ops import klt_kernel
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.utils import graphs

    slam = main_slam(world, device, caps, cfg_kw)
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
    ba_problems = []
    if capture_ba:
        from sadvio_tpu_torch.backend import ba

        backend = slam._backend

        def keeping(window, obs, imu_chain, priors, fixed_n, lines=None):
            fixed = torch.arange(slam.caps.K, device=device) < fixed_n  # as _backend builds it
            ba_problems.append(ba.BAProblem(window, obs, slam.rig, imu_chain, priors, fixed,
                                            False, lines))
            del ba_problems[:-capture_ba]
            return backend(window, obs, imu_chain, priors, fixed_n, lines)

        slam._backend = keeping
    stage_log = _time_stages(slam) if stages else None
    host_log = _time_stages(slam, CAPTURED_STAGES, sync=False) if stage_host else None
    imu.preintegrate.launches = 0
    klt_kernel.lk_iterate.launches = 0
    klt_kernel.lk_track.launches = 0
    klt_kernel.lk_track.launches_by_levels = {}
    frame_ms, is_kf, prof, outs, vi = [], [], None, [], []
    with graphs.eager() if eager else contextlib.nullcontext():
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
            vi.append(slam.vi_initialized)
            outs.append(out)
            if profile_frames and i == profile_frames[1]:
                prof_wall = time.perf_counter() - t_prof
                prof.__exit__(None, None, None)
        run_s = time.perf_counter() - t_run
    rec = {"engine": engine, "slam": slam, "frames": len(frames), "run_s": run_s,
           "vi_initialized": np.asarray(vi), "host_stages": host_log,
           "frame_ms": np.asarray(frame_ms), "is_kf": np.asarray(is_kf),
           "lk_iterate": klt_kernel.lk_iterate.launches, "lk_track": klt_kernel.lk_track.launches,
           "lk_track_by_levels": dict(klt_kernel.lk_track.launches_by_levels),
           "imu_preint": imu.preintegrate.launches,
           "stages": stage_log, "outs": outs, "captured": captured.get("state"),
           "ba_problems": ba_problems}
    est = np.asarray([t for _, _, t in slam.traj])
    _require(len(est) == len(frames), "one pose per frame expected")
    _require(np.isfinite(est).all() and all(np.isfinite(R).all() for _, R, _ in slam.traj),
             "non-finite pose")
    rec["est"] = est
    rec["rot"] = np.stack([R for _, R, _ in slam.traj])
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
            f"lk_iterate={rec['lk_iterate']} imu_preint={rec['imu_preint']}")


def phase_main_path(world, frames, device):
    """The full-width main path on the fused engine, its stages replayed as
    CUDA graphs: one lk_track launch per klt.track call and none of
    lk_iterate."""
    with _ClockSampler() as clocks:
        rec = run_slam(world, frames, device, "fused", capture_ba=PAR_B, stage_host=True)
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
    preint = _graph_stats(slam.graphs)["_preint"]  # a warm-up launch per variant, then replays
    _require(rec["imu_preint"] == preint["variants"] + preint["replays"] > 0,
             f"{rec['imu_preint']} IMU kernel launches for {preint} _preint calls")
    _require(slam.window.R.is_cuda and slam.window.lmk.is_cuda and slam.obs.uv.is_cuda,
             "window state left the card")
    return rec


# the main path's captured stages (utils/graphs.py), in the order of a frame
CAPTURED_STAGES = ("_preint", "_predict_cv", "_predict_imu", "_pyramids", "_frontend",
                   "_marg_roll", "_insert_kf", "_backend")
GRAPH_POS_TOL_M = 1e-4  # captured against eager, per frame
GRAPH_ROT_TOL_RAD = 1e-4
GRAPH_REPLAYS = 5  # replays timed between events, per stage


def _rotation_gap(Ra, Rb):
    """Per-frame angle (rad) of Ra^T Rb for stacks of rotations, from its
    sine and cosine (arccos alone reads float32 rounding as 1e-4 rad)."""
    M = np.einsum("nki,nkj->nij", Ra.astype(np.float64), Rb.astype(np.float64))
    s = 0.5 * np.linalg.norm(np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                                       M[:, 1, 0] - M[:, 0, 1]], -1), axis=-1)
    return np.arctan2(s, (np.trace(M, axis1=1, axis2=2) - 1.0) / 2.0)


def _replay_ms(graph, n=GRAPH_REPLAYS):
    """Device ms of one replay of a captured graph: events around each of n
    replays, the median."""
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _frame_times(rec):
    ms, kf = rec["frame_ms"], rec["is_kf"]
    return {"track_median_ms": float(np.median(ms[~kf][1:])),
            "kf_median_ms": float(np.median(ms[kf][1:])), "kf_max_ms": float(ms[kf][1:].max())}


def phase_graphs(world, frames, device, cap):
    """The main path again on the same world and frames under
    graphs.eager(), held against phase_main_path's captured run: the same
    keyframes and VIInit frame, per-frame positions within 1e-4 m and
    rotations within 1e-4 rad, the same lk_track count, and every captured
    stage replayed (replays ran under set_sync_debug_mode("error"), inside
    utils/graphs.py).  Prints per stage the variants, capture ms, replays,
    the host ms per call in both runs, the device ms of one replay (CUDA
    events) and, from torch.profiler in a fresh process, the kernels and
    device ms of one replay."""
    from sadvio_tpu_torch.utils import graphs

    eager = run_slam(world, frames, device, "fused", eager=True, stage_host=True)
    print(f"graphs: eager run: {_describe(eager)}")
    slam_c, slam_e = cap["slam"], eager["slam"]
    _require(not slam_e.graphs.variants, "the eager run captured a stage")
    _require((cap["is_kf"] == eager["is_kf"]).all(),
             f"keyframes differ: captured {np.flatnonzero(cap['is_kf']).tolist()} eager "
             f"{np.flatnonzero(eager['is_kf']).tolist()}")
    vi_c, vi_e = int(np.argmax(cap["vi_initialized"])), int(np.argmax(eager["vi_initialized"]))
    _require(cap["vi_initialized"].any() and vi_c == vi_e,
             f"VIInit at frame {vi_c} captured, {vi_e} eager")
    dpos = np.linalg.norm(cap["est"] - eager["est"], axis=1)
    drot = _rotation_gap(cap["rot"], eager["rot"])
    same_bits = bool((cap["est"] == eager["est"]).all() and (cap["rot"] == eager["rot"]).all())
    print(f"graphs: captured vs eager over {len(frames)} frames: max position gap "
          f"{dpos.max():.3e} m (frame {int(dpos.argmax())}), max rotation gap {drot.max():.3e} rad"
          f", bit for bit: {same_bits}; ATE {cap['ate'] * 1e3:.4f} mm captured, "
          f"{eager['ate'] * 1e3:.4f} mm eager; VIInit at frame {vi_c}; keyframes "
          f"{int(cap['is_kf'].sum())}")
    _require(dpos.max() <= GRAPH_POS_TOL_M, f"position gap {dpos.max():.3e} m")
    _require(drot.max() <= GRAPH_ROT_TOL_RAD, f"rotation gap {drot.max():.3e} rad")
    _require(cap["lk_track"] == eager["lk_track"],
             f"lk_track launches {cap['lk_track']} captured, {eager['lk_track']} eager")
    _require(cap["imu_preint"] == eager["imu_preint"],
             f"IMU kernel launches {cap['imu_preint']} captured, {eager['imu_preint']} eager")
    stats = _graph_stats(slam_c.graphs)
    for name in CAPTURED_STAGES:
        st = stats.get(name, {"variants": 0, "replays": 0})
        _require(st["replays"] > 0, f"stage {name} was never replayed ({st})")
        _require(st["variants"] <= graphs.MAX_VARIANTS, f"stage {name}: {st['variants']} variants")
    t0 = time.perf_counter()
    child = _graph_profile_fresh(slam_c)
    print(f"graphs: fresh-process profile {time.perf_counter() - t0:.1f} s")
    rows = {}
    for name in CAPTURED_STAGES:
        table = slam_c.graphs.variants[name]
        var = max(table.values(), key=lambda v: v.replays)
        he, hc = eager["host_stages"][name], cap["host_stages"][name]
        rows[name] = dict(stats[name], calls=len(hc), eager_host_ms=float(np.median(he)),
                          captured_host_ms=float(np.median(hc)), replay_ms=_replay_ms(var.graph),
                          **child.get(name, {}))
        r = rows[name]
        print(f"graphs: {name}: {r['variants']} variants captured in {r['capture_ms']:.1f} ms, "
              f"{r['replays']} replays of {r['calls']} calls; host ms per call (median) eager "
              f"{r['eager_host_ms']:.3f} captured {r['captured_host_ms']:.3f} (its capturing "
              f"calls included), per replay (mean) {r['replay_host_ms']:.3f}; one replay: "
              f"{r['replay_ms']:.4f} ms device (events), "
              f"{r.get('replay_kernels', 'not measured')} kernels and "
              f"{_ms(r.get('replay_device_ms'), 4)} device (profiler, fresh process)")
    fc, fe = _frame_times(cap), _frame_times(eager)
    print("graphs: frame ms (host clock to the end of the frame's device work, first frame "
          "and first keyframe left out): tracking median "
          f"{fc['track_median_ms']:.3f} captured / {fe['track_median_ms']:.3f} eager; keyframe "
          f"median {fc['kf_median_ms']:.3f} / {fe['kf_median_ms']:.3f}, max "
          f"{fc['kf_max_ms']:.3f} / {fe['kf_max_ms']:.3f}; run {cap['run_s']:.1f} s / "
          f"{eager['run_s']:.1f} s")
    print(f"graphs: graph memory pools: {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
          f"in all after both runs")
    return {"stages": rows, "captured": fc, "eager": fe, "bit_for_bit": same_bits,
            "max_pos_gap_m": float(dpos.max()), "max_rot_gap_rad": float(drot.max())}


def _graph_stats(graphs):
    """Per captured stage: variants captured, capture ms in all, replays and
    the host ms of one replay (the mean)."""
    out = {}
    for name, v in graphs.variants.items():
        n = sum(x.replays for x in v.values())
        out[name] = {"variants": len(v), "capture_ms": sum(x.capture_ms for x in v.values()),
                     "replays": n, "replay_host_ms":
                     1e3 * sum(x.replay_s for x in v.values()) / max(n, 1)}
    return out


def _graph_profile_fresh(slam):
    """The per-stage profiler rows of phase_graphs, taken in a new
    interpreter ({stage: {...}}, empty where the profile recorded no device
    time).  The inputs of each stage's most replayed variant go to the
    child through the git-ignored .smoke_profile/ (removed after)."""
    import shutil

    stages = {}
    for name in CAPTURED_STAGES:
        (spec, attrs), var = max(slam.graphs.variants[name].items(), key=lambda kv: kv[1].replays)
        stages[name] = {"spec": spec, "attrs": attrs, "inputs": [t.cpu() for t in var.static_in]}
    os.makedirs(PROFILE_DIR, exist_ok=True)
    path = os.path.join(PROFILE_DIR, "graph_stages.pt")
    torch.save(stages, path)
    try:
        proc = subprocess.run([sys.executable, "-c", f"import chip_smoke as c; "
                               f"c._graph_profile_child({path!r})"], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    _require(proc.returncode == 0, f"fresh-process graph profile: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _graph_profile_child(path):
    """Entry of the fresh process: each captured stage called on the saved
    inputs (its first call captures it), then one replay under
    torch.profiler; prints one JSON line."""
    import sadvio_tpu_torch  # noqa: F401  (pins full fp32)
    from sadvio_tpu_torch.utils import graphs

    device = torch.device("cuda")
    world, _ = make_world(device, 2)  # the main world's rig and IMU parameters
    slam = main_slam(world, device)
    out = {}
    for name, d in torch.load(path, weights_only=False).items():
        slam.klt_engine = "fused"
        args, kwargs = graphs._unflatten(d["spec"], iter([t.to(device) for t in d["inputs"]]))
        getattr(slam, name)(*args, **kwargs)
        (var,) = slam.graphs.variants[name].values()
        row = {}
        tab, _ = _profile(var.graph.replay, n=1)
        if tab:
            row["replay_kernels"] = sum(c for c, _ in tab.values())
            row["replay_device_ms"] = sum(us for _, us in tab.values()) / 1e3
        out[name] = row
    print(json.dumps(out))


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
        print(f"long run: stage {key}: timed calls {len(ms)} mean {np.mean(ms):.3f} ms median "
              f"{np.median(ms):.3f} ms max {np.max(ms):.3f} ms")
    print(f"long run: stage optimize_archive: 1 call {opt_ms:.1f} ms ({len(nodes)} nodes, "
          f"{len(slam.pose_graph_edges)} edges)")
    stats = {k: tuple(round(x, 1) for x in v.values())
             for k, v in _graph_stats(slam.graphs).items()}
    print(f"long run: captured stages (variants, capture ms, replays, host ms per replay): {stats}")
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
        if not table:
            print(f"measure: stage {key}: kernels and device time not measured")
            continue
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
            print(f"matcher run: stage detect.brief_describe: eager calls {len(ms)} (inside "
                  f"the captured front end only its first calls are eager) median "
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
# 40 frames (60 before the typed channels' phases came in), to hold the
# command time; the gates are the same
EXOTIC_FRAMES = 40
EXOTIC_STEREO_ATE_TOL_M = 0.06  # tests/test_pipeline_stress.py's exotic-camera gate


def preset_config(name, **kw):
    """configs/<name>/config.yaml with the smoke capacities: K from its
    max_kf_number, L=512, P=48, 4 levels, radius 5."""
    import dataclasses

    from sadvio_tpu_torch.pipeline.config import Capacities, load_slam_config

    cfg = load_slam_config(os.path.join(REPO, "configs", name, "config.yaml"))
    return dataclasses.replace(cfg, caps=Capacities(K=cfg.max_kf_number + 1, **MODE_CAPS), **kw)


class _CaptureTrack:
    """Keep the arguments of every warped klt.track call (the frame tracks)
    while a run goes (the pipeline modules call it through the module, so
    patching the attribute is enough; the original is put back on exit).
    ``args`` is the n-th call's, None for n=0.  A replayed graph calls no
    Python, so the stages run eagerly (graphs.eager()) until the n-th call
    is kept and are captured after it; with n=0 the whole run is eager."""

    def __init__(self, n=0):
        self.n, self.calls = n, []

    @property
    def args(self):
        return self.calls[self.n - 1] if 0 < self.n <= len(self.calls) else None

    def __enter__(self):
        from sadvio_tpu_torch.frontend import klt
        from sadvio_tpu_torch.utils import graphs

        self.klt, self.orig = klt, klt.track
        self.eager = graphs.eager()
        self.eager.__enter__()

        def track(*a, **k):
            if k.get("warp") is not None and not torch.cuda.is_current_stream_capturing():
                self.calls.append((a, dict(k)))
                if len(self.calls) == self.n:
                    self._end_eager()
            return self.orig(*a, **k)

        klt.track = track
        return self

    def _end_eager(self):
        if self.eager is not None:
            self.eager.__exit__(None, None, None)
            self.eager = None

    def __exit__(self, *exc):
        self.klt.track = self.orig
        self._end_eager()


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
    with _CaptureTrack(capture) if capture else contextlib.nullcontext() as cap:
        rec = _drive_mode(slam, [f._replace(images=f.images[:1]) for f in frames])
    rec["capture"], rec["stages"] = cap.args if capture else None, stages
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
    0.7-1.4 of the truth's; either run is held bit for bit to the same run
    eager.  The inputs of one frame track of the mono run are kept for the
    kernel check at that call shape."""
    if vio:
        preset, kw = "euroc_monovio", dict(max_movement_parallax=MONOVIO_MAX_PARALLAX)
        rec = run_mono(world, frames, device, preset, vio, **kw)
    else:
        preset, kw = "euroc_mono", {}
        rec = run_mono(world, frames, device, preset, vio, capture=MONO_CAPTURE_CALL)
    _held_to_eager(preset, rec, lambda: run_mono(world, frames, device, preset, vio, **kw))
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


def _held_to_eager(name, rec, rerun):
    """The captured run ``rec`` of a mode held to ``rerun()`` under
    graphs.eager(): the same keyframes and every frame's pose bit for bit,
    and the keyframe insertion replayed as a graph."""
    from sadvio_tpu_torch.utils import graphs

    with graphs.eager():
        eager = rerun()
    rot = lambda r: np.stack([R for _, R, _ in r["slam"].traj])
    same = bool((rec["is_kf"] == eager["is_kf"]).all() and (rec["est"] == eager["est"]).all()
                and (rot(rec) == rot(eager)).all())
    st = _graph_stats(rec["slam"].graphs).get("_insert_kf", {"variants": 0, "replays": 0})
    print(f"{name}: captured vs eager over {rec['frames']} frames: bit for bit {same}; "
          f"_insert_kf {st['variants']} variants, {st['replays']} replays")
    _require(not eager["slam"].graphs.variants, f"{name}: the eager run captured a stage")
    _require(same, f"{name}: the captured run's poses differ from the eager run's")
    _require(st["replays"] > 0, f"{name}: the keyframe insertion was never replayed")


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
    the gates of tests/test_nofov_pipeline.py's recovery test, and the run
    held bit for bit to the same run eager.  Every camera-1 re-track is
    recorded with its rotation; the widest one is kept for the kernel check
    at that call shape."""
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM

    world, frames = make_nofov_world(device)

    def drive():
        slam = NoFovSLAM(world.rig,
                         preset_config("nofov", max_movement_parallax=NOFOV_MAX_PARALLAX),
                         device=device)
        calls = _count_calls(slam, ("_track_cam1",))
        stages = _time_stages(slam, ("_try_bootstrap", "_estimate_scale_window", "_backend"))
        refine = slam._track_cam1_refine
        retracks = []

        def recorded(pyr_a, pyr_b, uv_a, init, valid, R_1):
            retracks.append((_rotation_deg(R_1.cpu().numpy()),
                             (pyr_a, pyr_b, uv_a, init, valid, R_1)))
            return refine(pyr_a, pyr_b, uv_a, init, valid, R_1)

        slam._track_cam1_refine = recorded
        perturbed = []

        def perturb(i, s):
            if not perturbed and s.scale_state["applied"] and i >= NOFOV_PERTURB_AFTER:
                s._apply_scale_window(NOFOV_PERTURB)
                perturbed.append(i)

        rec = _drive_mode(slam, frames, after_frame=perturb)
        return rec, calls, stages, retracks, perturbed

    rec, calls, stages, retracks, perturbed = drive()
    _held_to_eager("nofov", rec, lambda: drive()[0])
    slam = rec["slam"]
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
                             valid0.contiguous(), kw["warp"].contiguous(), 1, LEVELS)


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
                            valid.contiguous(), warp.contiguous(), 1, LEVELS)
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

# ----------------------------------------------------------------------
# the typed feature channels: lines in the window BA, edgelets, coded
# ellipse patterns, provider boxes, csv keypoints, the descriptor zoo
# ----------------------------------------------------------------------

# cuts: multithreading 0 (phase_euroc runs the preset with it, on and off)
# and the keyframe parallax 4.0 -> 1.0 deg: at 4.0 every keyframe after the third of
# this world comes from the 1 s timer, 21 frames apart, and in 130 frames the
# 13-slot window neither rolls nor reaches VIInit (a CPU run at 376x240: 9
# keyframes); the monovio run cuts it the same way
LINE_PRESET = "euroc_bimonovio_full"
LINE_MAX_PARALLAX = 1.0
LINE_FRAMES, LINE_SEGMENTS = 130, 12
LINE_ATE_TOL_M = 0.05
LINE_MIN_IN_BA = 6
# median line-landmark distance to a true 3D line (the map taken into the
# ground truth's world by the last keyframe's pose): 0.5 m on the starved
# world, as tests/test_line_e2e.py gates it; on the dense 400-blob wall 2.0 m
# for the lines in the BA (the ones that constrain poses), a gross-failure
# gate: the blobs under the segments pull the detected lines 0.5-3 px off
# (frame 0, 752x480, a CPU run), one pixel of disparity is 1.6 m of
# depth at 6 m with the 0.11 m baseline, and mis-paired parallel lines are
# born metres off; the whole map's distribution is printed beside it
LINE_MAP_TOL_M = 0.5
FULL_LINE_MAP_TOL_M = 2.0
STARVED = dict(seed=7, n_frames=24, width=320, height=240, n_points=20, n_lines=12,
               imu_noise=False)  # tests/test_line_e2e.py's world
# lines must not make the starved world worse, in the median over the
# pipeline's RANSAC seeds 0..6.  One run's ratio moves with any change of
# rounding (the tracks sit on line edges, where KLT is ill-posed): 0.80 with
# 3 CPU threads, 0.92 with 4; the median over the seeds was 0.861 on the CPU
# and 0.932 on an NVIDIA H100 80GB HBM3 at 700 W, so tests/test_line_e2e.py's
# single-run 0.9 holds on the CPU (tests/test_torch_line_pipeline.py) but not
# here; the JAX package itself gives 0.72 on this seed and 0.99, 1.37, 1.02
# on seeds 8-10
STARVED_RATIO = 1.0
STARVED_SEEDS = 5  # 7 before the parallel, async and typed-mode phases came in
CHANNEL_FRAMES = 40
# a 2 m pattern (20 px markers): at 752x480 the dark background of the blob
# world needs more than connected_components' 512 steps, and the cap leaves
# it as a ladder of ~600 px fragments that take the 32 blob slots from the
# 10 px markers of the JAX test's 1 m pattern (ROADMAP queue C)
PATTERN_ANCHOR, PATTERN_SIDE, PATTERN_ID = (1.2, 0.6, 5.0), 2.0, 9
BOX_CENTER, BOX_SIZE = (-1.0, 0.4, 5.5), 0.8
DESC_KEYPOINTS = 512
DESC_BITS_OK = 0.98  # share of features whose card and CPU descriptors differ in <= 2 bits
DOH_RTOL = 1e-4


def _seg_errors(segments, slam, world):
    """Per line landmark: the larger distance of its two endpoints to the
    nearest true 3D line, the map taken into the ground truth's world by the
    last keyframe's pose (estimated and true; the estimator's world is its
    first keyframe's, gravity-aligned with the IMU and re-gauged by VIInit).
    A trajectory fit would not do: over a short, nearly straight path the
    rotation about the path is unobservable, and it swings a wall 6 m away
    by metres."""
    ts, R_e, t_e = slam.kf_traj[-1]
    i = int(round(ts * 20.0))  # the synthetic worlds run at 20 Hz
    R = world.gt_R[i].astype(np.float64) @ np.asarray(R_e, np.float64).T
    t = world.gt_t[i].astype(np.float64) - R @ np.asarray(t_e, np.float64)
    segments = np.asarray(segments, np.float64) @ R.T + t

    def pld(p, a, b):
        d = (b - a) / np.linalg.norm(b - a)
        r = p - a
        return np.linalg.norm(r - (r @ d) * d)

    return sorted(min(max(pld(s[0], g[0], g[1]), pld(s[1], g[0], g[1])) for g in world.segments)
                  for s in segments)


def _device_profile(name, fn, n=3):
    """Kernels and device ms per call of fn by torch.profiler (reported as
    not measured where it records no device time)."""
    table, wall = _profile(fn, n=n)
    if not table:
        print(f"lines: {name}: kernels and device time not measured")
        return None
    k = sum(c for c, _ in table.values()) / n
    ms = sum(us for _, us in table.values()) / n / 1e3
    print(f"lines: {name}: {k:.0f} kernels, {ms:.3f} ms of device time per call "
          f"({wall / n * 1e3:.1f} ms of wall with the profiler on)")
    return {"kernels": k, "device_ms": ms}


def phase_lines(device):
    """configs/euroc_bimonovio_full (cuts: multithreading 0, keyframe
    parallax 1.0 deg) at 752x480, K=13, L=512, P=48, pointxd + linexd in the
    window BA, global map, pose graph and mesh, over the main path's world
    (seed 5) with 12 bright 3D segments,
    130 frames; then tests/test_line_e2e.py's starved world with and without
    lines (over five RANSAC seeds: lines must not make it worse in the
    median, and their map must lie within 0.5 m of the true lines); then
    detect_lines twice on one frame, which must be bit-equal."""
    from sadvio_tpu_torch.frontend import lines as lines_mod
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, FeatureConfig, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    world, frames = make_world(device, LINE_FRAMES, n_lines=LINE_SEGMENTS)
    cfg = preset_config(LINE_PRESET, multithreading=False,
                        max_movement_parallax=LINE_MAX_PARALLAX)
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device=device)
    stages = _time_stages(slam, ("_insert_kf", "_backend", "_marg_roll", "_run_vi_init"))
    ch = slam._line_ch
    pre_ba = _time_stages(ch, ("on_keyframe_pre_ba",))
    with _TimedFunctions((("lines", "detect_lines"),)) as timed:
        rec = _drive_mode(slam, frames)
    det = timed.log["lines.detect_lines"]
    outs = rec["outs"]
    rec["ate"] = synthetic.ate_rmse(rec["est"], world.gt_t[: rec["frames"]])
    kf_outs = [o for o in outs if o.get("is_kf") and "n_lines" in o]
    in_ba = int(ch.ba_block().mask.sum())
    errs = _seg_errors(ch.segments(), slam, world)
    med = errs[len(errs) // 2] if errs else float("inf")
    blk = ch.ba_block()
    ba_errs = _seg_errors(blk.ends[blk.mask].cpu().numpy(), slam, world)
    ba_med = ba_errs[len(ba_errs) // 2] if ba_errs else float("inf")
    _mode_summary(f"lines {LINE_PRESET}", rec,
                  f" | ATE {rec['ate'] * 1e3:.3f} mm, VIInit {slam.vi_initialized}, lines at the "
                  f"last keyframe {kf_outs[-1]['n_lines']} ({kf_outs[-1]['n_lines_tracked']} "
                  f"tracked), {in_ba} in the BA block, line map {len(errs)} landmarks, median "
                  f"error to a true line {med * 1e3:.1f} mm (quartiles "
                  f"{np.round(np.percentile(errs, [25, 75]), 3)} m), of the lines in the BA "
                  f"{ba_med * 1e3:.1f} mm (all {np.round(ba_errs, 3)} m)")
    _stage_summary("lines", stages)
    _stage_summary("lines", pre_ba)
    _stage_summary("lines", timed.log)
    print(f"lines: per keyframe: line_channel {np.mean(pre_ba['on_keyframe_pre_ba']):.2f} ms "
          f"(detect_lines {np.mean(det):.2f} ms x 2), window BA with "
          f"lines {np.mean(stages['_backend']):.2f} ms")
    _require(slam.n_resets == 0, "lines: the run reset")
    _require(slam.vi_initialized, "lines: VIInit never fired")
    _require(len(slam.archived_kf) >= 1, "lines: the window never rolled")
    _require(rec["ate"] < LINE_ATE_TOL_M, f"lines: ATE {rec['ate']:.4f} m")
    _require(in_ba >= LINE_MIN_IN_BA, f"lines: {in_ba} lines in the BA at the last keyframe")
    _require(ba_med < FULL_LINE_MAP_TOL_M, f"lines: median error {ba_med:.3f} m of the BA lines")
    _require(rec["lk_track"] == _accounted_tracks(rec) and rec["lk_iterate"] == 0,
             f"lines: {rec['lk_track']} lk_track launches for {_accounted_tracks(rec)} tracks")
    _require(ch.obs_mask.is_cuda and ch.p0.is_cuda, "lines: the line map left the card")

    # the starved world: lines must beat points
    # float frames, as the JAX test runs it: the outcome of this comparison
    # moves with any change of the front end's inputs (PERF.md)
    sw = synthetic.make_world(device=device, **STARVED)
    ates = {"points": [], "lines": []}
    map_err = []
    for seed in range(STARVED_SEEDS):
        for name, feats in (("points", (FeatureConfig(),)),
                            ("lines", (FeatureConfig(), FeatureConfig(label="linexd")))):
            scfg = SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                              max_movement_parallax=1.0, min_movement_parallax=0.02,
                              features=feats, caps=Capacities(K=6, L=160, P=24, pyr_levels=3,
                                                              klt_radius=5))
            srec = _drive_mode(StereoSLAM(sw.rig, scfg, seed=seed, device=device), sw.frames)
            ates[name].append(synthetic.ate_rmse(srec["est"], sw.gt_t))
            if name == "lines":
                e = _seg_errors(srec["slam"]._line_ch.segments(), srec["slam"], sw)
                map_err.append(e[len(e) // 2] if e else float("inf"))
    ratios = np.asarray(ates["lines"]) / np.asarray(ates["points"])
    ates["median_ratio"] = float(np.median(ratios))
    print(f"lines: starved world (seed 7, 24 frames, 320x240, 20 blobs, 12 segments), RANSAC "
          f"seeds 0-{STARVED_SEEDS - 1}: ATE points {np.round(np.asarray(ates['points']) * 1e3, 3)}"
          f" mm, lines {np.round(np.asarray(ates['lines']) * 1e3, 3)} mm, ratios "
          f"{np.round(ratios, 3)}, median {ates['median_ratio']:.3f}; median line-landmark "
          f"error {np.round(map_err, 3)} m")
    _require(ates["median_ratio"] < STARVED_RATIO, f"starved world: median ratio {ratios}")
    _require(np.median(map_err) < LINE_MAP_TOL_M, f"starved world: line map errors {map_err}")
    ates["map_err"] = map_err

    # determinism: two detections of one frame, bit for bit
    mid = len(frames) // 2
    img = torch.as_tensor(frames[mid].images[1], device=device).float()
    a = lines_mod.detect_lines(img, n_lines=ch.n_detect)
    b = lines_mod.detect_lines(img, n_lines=ch.n_detect)
    _require(all(torch.equal(x, y) for x, y in zip(a, b)), "detect_lines differs between calls")
    c = lines_mod.detect_lines(img.cpu(), n_lines=ch.n_detect)
    same = torch.equal(a[2].cpu(), c[2])
    gap = (a[0].cpu() - c[0])[c[2]].abs().max().item() if same and c[2].any() else float("nan")
    print(f"lines: detect_lines 752x480 twice on the card: bit-equal; against the CPU: same "
          f"valid set {same}, endpoints within {gap:.2e} px")
    prof = {"detect_lines": _device_profile("detect_lines 752x480, 24 lines",
                                            lambda: lines_mod.detect_lines(img, n_lines=24))}
    standalone = type(ch)(slam.rig, n_slots=ch.M, n_detect=ch.n_detect)
    f0 = frames[mid]
    im0, im1 = [torch.as_tensor(f0.images[c], device=device).float() for c in range(2)]
    R, t = slam.window.R[0], slam.window.t[0]
    prof["refine"] = _device_profile(
        "standalone line update with the batched Gauss-Newton (32 slots, 8 iterations)",
        lambda: standalone.on_keyframe(None, im0, im1, R, t))
    rec.update(stages=stages, pre_ba=pre_ba, detect=det, starved=ates, in_ba=in_ba,
               line_err=med, ba_line_err=ba_med, profile=prof)
    return rec


def _render_marker(img, c, r, payload, sync=(1, 0, 1, 1, 0, 0, 1, 0)):
    """One coded marker (dark disk + code ring of 16 slots x 8 samples,
    sync word then payload MSB first) drawn into img (numpy), as the JAX
    package's ellipse tests draw it."""
    bits = np.asarray(list(sync) + [(payload >> (7 - i)) & 1 for i in range(8)])
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    dx, dy = xs - c[0], ys - c[1]
    rho = np.hypot(dx, dy)
    ang = np.mod(np.arctan2(dy, dx), 2 * np.pi)
    i = np.round((2 * np.pi - ang) / (2 * np.pi / 128)).astype(np.int64) % 128
    dark = (rho <= r) | ((rho > 1.45 * r) & (rho < 1.9 * r) & (bits[i // 8] == 1))
    img[dark] = 30.0
    return img


def _project_np(world, i, pts, c=0):
    """Pinhole projection of world points (N,3) into camera c at frame i
    (host numpy): uv (N,2), in front (N,)."""
    R, t = world.gt_R[i].astype(np.float64), world.gt_t[i].astype(np.float64)
    Rfs = world.rig.R_f_s[c].cpu().numpy().astype(np.float64)
    tfs = world.rig.t_f_s[c].cpu().numpy().astype(np.float64)
    p_c = ((np.asarray(pts, np.float64) - t) @ R - tfs) @ Rfs
    cam = world.rig.cam
    fx, fy, cx, cy = (float(getattr(cam, k)[c]) for k in ("fx", "fy", "cx", "cy"))
    z = np.maximum(p_c[:, 2], 1e-6)
    uv = np.stack([fx * p_c[:, 0] / z + cx, fy * p_c[:, 1] / z + cy], -1)
    return uv, p_c[:, 2] > 0.3


def _stamp_pattern(world, i, img):
    """A 4-marker pattern (ID PATTERN_ID, side PATTERN_SIDE) fixed at
    PATTERN_ANCHOR, stamped into camera 0's image of frame i: bright patch,
    then markers 1, 2, 3 and the ID at the projected corners."""
    a = np.asarray(PATTERN_ANCHOR)
    s = PATTERN_SIDE
    corners = np.stack([a, a + [-s, 0, 0], a + [0, -s, 0], a + [-s, -s, 0]])
    uv, _ = _project_np(world, i, corners)
    depth = (world.gt_R[i].T @ (a - world.gt_t[i]))[2]
    r = s * float(world.rig.cam.fx[0]) / depth / 4.0
    img = img.astype(np.float64)
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W]
    for c in uv:
        img[(xs - c[0]) ** 2 + (ys - c[1]) ** 2 < (2.4 * r) ** 2] = 220.0
    for c, pid in zip(uv, (1, 2, 3, PATTERN_ID)):
        _render_marker(img, c, r, pid)
    return np.clip(img, 0, 255).astype(np.uint8)


def _box_provider(world):
    """Ground-truth boxes of a BOX_SIZE cube at BOX_CENTER in both cameras,
    by frame timestamp (the reference's provider contract)."""
    corners = np.asarray(BOX_CENTER) + np.asarray(
        [[a, b, c] for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)]) * BOX_SIZE / 2
    index = {}

    def provider(ts):
        i = index[ts]
        boxes, valid = [], []
        for c in range(2):
            uv, vis = _project_np(world, i, corners, c)
            boxes.append(np.stack([uv.min(0), uv.max(0)])[None])
            valid.append([bool(vis.all())])
        return {"boxes": np.stack(boxes), "labels": np.zeros((2, 1), np.int64),
                "valid": np.asarray(valid)}

    return provider, index


def phase_channels(device, probe=None):
    """Edgelet, coded-ellipse, box and csv-keypoint runs, 40 frames each on
    the main path's world at 752x480 (the main path's settings), each held
    to its JAX test's gate (tests/test_channels.py).  `probe(after)` runs
    after each of the four runs."""
    import tempfile

    from sadvio_tpu_torch.frontend import ellipses as ell
    from sadvio_tpu_torch.pipeline import channels as chan_mod
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, FeatureConfig, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    world, frames = make_world(device, CHANNEL_FRAMES)

    def config(*extra):
        return SLAMConfig(slam_mode="bimono", max_kf_number=10, min_lmk_number=40,
                          max_movement_parallax=1.0, min_movement_parallax=0.02,
                          features=extra or (FeatureConfig(),), caps=Capacities(**MAIN_CAPS))

    recs = {}

    def run(name, cfg, fr, setup=None):
        slam = StereoSLAM(world.rig, cfg, device=device)
        if setup:
            setup(slam)
        timed = {type(c).__name__: _time_stages(c, ("on_keyframe",)) for c in slam.channels}
        rec = _drive_mode(slam, fr)
        rec["stages"] = {k: v["on_keyframe"] for k, v in timed.items()}
        rec["ate"] = synthetic.ate_rmse(rec["est"], world.gt_t[: rec["frames"]])
        recs[name] = rec
        if probe is not None:
            probe(f"phase_channels({name})")
        _require(slam.n_resets == 0, f"{name}: the run reset")
        _require(rec["lk_track"] == _accounted_tracks(rec) and rec["lk_iterate"] == 0,
                 f"{name}: {rec['lk_track']} lk_track launches")
        return slam, rec

    slam, rec = run("edgelet", config(FeatureConfig(), FeatureConfig(label="edgeletxd")), frames)
    p, d = [c for c in slam.channels if isinstance(c, chan_mod.EdgeletChannel)][0].points()
    band = float(np.mean((p[:, 2] > 2.5) & (p[:, 2] < 11.0))) if len(p) else 0.0
    _mode_summary("channels edgelet", rec, f" | {len(p)} edgelets, {band:.2f} in the depth "
                  f"band, unit directions {np.allclose(np.linalg.norm(d, axis=-1), 1, atol=1e-3)}")
    _require(len(p) >= 5 and band > 0.6 and np.allclose(np.linalg.norm(d, axis=-1), 1, atol=1e-3),
             "edgelet channel under its gate")

    stamped = [f._replace(images=np.stack([_stamp_pattern(world, i, f.images[0]), f.images[1]]))
               for i, f in enumerate(frames)]
    cfg = config(FeatureConfig(), FeatureConfig(label="ellipsepatternxd",
                                                pattern_side=PATTERN_SIDE))
    with _TimedFunctions((("ellipses", "connected_components"),)) as cc:
        slam, rec = run("ellipse", cfg, stamped)
    pid, _, t_w_p = [c for c in slam.channels if isinstance(c, chan_mod.EllipseChannel)][0] \
        .patterns()
    err = (float(np.linalg.norm(t_w_p[pid.tolist().index(PATTERN_ID)] - PATTERN_ANCHOR))
           if PATTERN_ID in pid.tolist() else float("inf"))
    fg = ell.binarize_dark(torch.as_tensor(stamped[20].images[0], device=device).float())
    _, steps = ell.connected_components(fg, return_steps=True)
    ms_cc = cc.log["ellipses.connected_components"]
    _mode_summary("channels ellipse", rec, f" | pattern ids {pid.tolist()}, anchor error "
                  f"{err * 1e3:.1f} mm; connected_components 752x480 {np.mean(ms_cc):.2f} ms per "
                  f"call over {len(ms_cc)} calls, {steps} pool steps on frame 20")
    _require(err < 0.5, f"ellipse channel: pattern {PATTERN_ID} at {err:.3f} m")
    recs["ellipse"].update(cc_ms=ms_cc, cc_steps=steps)

    provider, index = _box_provider(world)
    index.update({f.ts: i for i, f in enumerate(frames)})
    slam, rec = run("bbox", config(FeatureConfig(), FeatureConfig(label="bboxxd")), frames,
                    setup=lambda s: setattr(s.channels[0], "provider", provider))
    centers, scales, _ = [c for c in slam.channels if isinstance(c, chan_mod.BBoxChannel)][0] \
        .boxes()
    errs = np.linalg.norm(centers - np.asarray(BOX_CENTER), axis=-1) if len(centers) else [np.inf]
    s0 = scales[int(np.argmin(errs))][0] if len(centers) else 0.0
    _mode_summary("channels bbox", rec, f" | {len(centers)} boxes, centre error "
                  f"{min(errs) * 1e3:.1f} mm, width {s0:.3f} m of {BOX_SIZE}")
    _require(min(errs) < 0.4 and 0.4 * BOX_SIZE < s0 < 2.5 * BOX_SIZE, "box channel under its gate")

    with tempfile.TemporaryDirectory() as folder:
        for i, f in enumerate(frames):
            uv, vis = _project_np(world, i, world.points)
            vis &= (uv[:, 0] >= 0) & (uv[:, 0] < 752) & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
            rows = ["u, v, desc"] + [f"[{u:.2f}, {v:.2f}], [0.0]" for u, v in uv[vis]]
            with open(os.path.join(folder, f"{int(round(f.ts * 1e9))}.csv"), "w") as fh:
                fh.write("\n".join(rows))
        cfg = config(FeatureConfig(label="pointxd", detector="csv", folder=folder))
        slam, rec = run("csv", cfg, frames)
        _require(slam._use_csv, "csv detector not in use")
    _mode_summary("channels csv", rec, f" | ATE {rec['ate'] * 1e3:.3f} mm")
    _require(rec["ate"] < ATE_TOL_M, f"csv keypoints: ATE {rec['ate']:.4f} m")
    for name, r in recs.items():
        for stage, ms in r["stages"].items():
            if ms:
                print(f"channels {name}: {stage}.on_keyframe: calls {len(ms)} mean "
                      f"{np.mean(ms):.2f} ms median {np.median(ms):.2f} ms")
    return recs


def phase_descriptors(frame, device):
    """orb_describe, brisk_describe and hessian_score on the card against
    the CPU, at 512 keypoints on a 752x480 frame."""
    from sadvio_tpu_torch.frontend import descriptors as dsc

    img_h = np.asarray(frame.images[0], np.float32)
    uv_h = np.random.default_rng(0).uniform(24.0, [752 - 25, 480 - 25],
                                            (DESC_KEYPOINTS, 2)).astype(np.float32)
    img, uv = torch.as_tensor(img_h, device=device), torch.as_tensor(uv_h, device=device)
    rows = {}
    for name, fn in (("orb_describe", dsc.orb_describe), ("brisk_describe", dsc.brisk_describe)):
        d_card, d_cpu = fn(img, uv).cpu(), fn(torch.as_tensor(img_h), torch.as_tensor(uv_h))
        ham = (d_card != d_cpu).sum(-1).numpy()
        ok = float(np.mean(ham <= 2))
        ms = _loop_ms(lambda: fn(img, uv))
        print(f"descriptors: {name} {tuple(d_card.shape)}: card vs CPU {ok * 100:.2f}% of "
              f"features within 2 bits (max {ham.max()} bits), {ms:.3f} ms per call")
        _require(ok >= DESC_BITS_OK, f"{name}: {ok:.3f} of features within 2 bits")
        rows[name] = {"within_2_bits": ok, "ms": ms}
    h_card, h_cpu = dsc.hessian_score(img).cpu(), dsc.hessian_score(torch.as_tensor(img_h))
    rel = float((h_card - h_cpu).abs().max() / h_cpu.abs().max())
    ms = _loop_ms(lambda: dsc.hessian_score(img))
    print(f"descriptors: hessian_score 752x480: card vs CPU max gap {rel:.2e} of the peak, "
          f"{ms:.3f} ms per call")
    _require(rel < DOH_RTOL, f"hessian_score: card vs CPU {rel:.2e}")
    rows["hessian_score"] = {"rel_gap": rel, "ms": ms}
    return rows


def phase_profiler_probe(after, frames, device, log):
    """Does torch.profiler record lk_track's launch at this point of the
    run?  One frame-shape track under the profiler; the answer is logged
    with the phase it follows."""
    from sadvio_tpu_torch.ops import klt_kernel

    pyr0, pyr1, uv0, init, valid0, warp, bwd = _track_inputs(frames, device, "frame")
    counts = (klt_kernel.lk_track.launches, dict(klt_kernel.lk_track.launches_by_levels))
    table, _ = _profile(lambda: klt_kernel.lk_track(
        pyr0, pyr1, uv0, init, valid0, warp, levels=LEVELS, radius=RADIUS, iters=ITERS,
        iters_coarse=ITERS_COARSE, bwd_levels=bwd), n=1)
    # probe launches are not the path's
    klt_kernel.lk_track.launches, klt_kernel.lk_track.launches_by_levels = counts
    seen = any("lk_track" in k for k in table)
    log.append((after, seen, len(table)))
    print(f"profiler probe after {after}: lk_track {'recorded' if seen else 'NOT recorded'} "
          f"({len(table)} device kernels in the table)")



# ----------------------------------------------------------------------
# the EuRoC entry point (sadvio_tpu_torch.run_euroc) on the main world on disk
# ----------------------------------------------------------------------

EUROC_DIR = os.path.join(REPO, ".smoke_euroc")  # git-ignored; removed after the phase
EUROC_T0 = 1403636579.0  # the first frame's stamp: EuRoC's epoch scale (s)
EUROC_SAVE_AT = 65  # frames before the checkpoint
EUROC_FULL_PRESET, EUROC_FULL_FRAMES = "euroc_bimonovio_full", 40
EUROC_RESUME_FLOOR_M = 1e-6
EUROC_IMG_TOL = 1e-3  # clahe and remap, card against CPU (float32 either way)
# configs/euroc_bimonovio with the main path's keyframe keys and capacities
EUROC_MAIN_KEYS = dict(max_kf_number=10, min_lmk_number=40, max_movement_parallax=1.0,
                       min_movement_parallax=0.02,
                       capacities=dict(L=N_FEATURES, P=48, pyr_levels=LEVELS, klt_radius=RADIUS))


def _euroc_config(preset, name, dataset_yaml, **keys):
    """A config directory: configs/<preset>/config.yaml with ``keys``
    replaced, beside the sequence's dataset.yaml."""
    import shutil

    import yaml

    with open(os.path.join(REPO, "configs", preset, "config.yaml")) as f:
        y = yaml.safe_load(f)
    y.update(keys)
    d = os.path.join(EUROC_DIR, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.yaml"), "w") as f:
        yaml.safe_dump(y, f)
    shutil.copy(dataset_yaml, os.path.join(d, "dataset.yaml"))
    return d


def _positions(slam):
    return np.asarray([t for _, _, t in slam.traj])


def _euroc_build(cfg_dir, data_dir, device):
    """The entry point's building blocks: (slam, provider, loader)."""
    from sadvio_tpu_torch import run_euroc
    from sadvio_tpu_torch.pipeline import euroc

    cfg, ds = run_euroc.load_configs(cfg_dir)
    provider, loader = run_euroc.open_provider(data_dir, ds, cfg.contrast_enhancer, device)
    slam = run_euroc.build_slam(cfg, euroc.rig_from_dataset(ds, device),
                                run_euroc.imu_params_of(ds), device)
    return slam, provider, loader


def _timed_frames(slam):
    """Wall ms of each process_frame call (the frame's health copy is its
    sync), filled as the run goes."""
    ms, orig = [], slam.process_frame

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    slam.process_frame = timed
    return ms


def phase_euroc(world, frames, device, measure=False):
    """The main world as a EuRoC sequence on disk, replayed through the
    entry point; a checkpoint resume; the full preset with multithreading
    and CLAHE; clahe and remap on the card against the CPU."""
    import itertools
    import shutil

    from sadvio_tpu_torch import run_euroc
    from sadvio_tpu_torch.ops import klt_kernel
    from sadvio_tpu_torch.pipeline import euroc, synthetic
    from sadvio_tpu_torch.pipeline.config import load_dataset_config
    from sadvio_tpu_torch.utils import checkpoint

    shutil.rmtree(EUROC_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    data = euroc.write_sequence(os.path.join(EUROC_DIR, "seq"), frames, t0=EUROC_T0)
    ds_yaml = os.path.join(EUROC_DIR, "dataset.yaml")
    euroc.write_dataset_yaml(ds_yaml, world.rig, world.imu_params)
    cfg_main = _euroc_config("euroc_bimonovio", "main", ds_yaml, **EUROC_MAIN_KEYS)
    print(f"euroc: wrote {len(frames)} stereo frames at {frames[0].images.shape[2]}x"
          f"{frames[0].images.shape[1]} (uint8 PNG, ns stamps from {EUROC_T0:.0f} s) and "
          f"imu0/data.csv in {time.perf_counter() - t0:.1f} s")
    stamps = EUROC_T0 + np.asarray([f.ts for f in frames])

    # 1. the entry point, as `python -m sadvio_tpu_torch.run_euroc` runs it
    log = os.path.join(EUROC_DIR, "log_slam")
    klt_kernel.lk_iterate.launches = 0
    klt_kernel.lk_track.launches = 0
    klt_kernel.lk_track.launches_by_levels = {}
    slam_a, n, loader, run_s = run_euroc.replay(cfg_main, data, device=device, profile=True,
                                                log_dir=log)
    launches = klt_kernel.lk_track.launches
    _require(klt_kernel.lk_iterate.launches == 0, "the entry point launched the per-level kernel")
    _require(n == len(frames), f"the loader gave {n} of {len(frames)} frames")
    res = np.loadtxt(os.path.join(log, "results.csv"), delimiter=",", ndmin=2)
    idx = [int(np.argmin(np.abs(stamps - ts))) for ts in res[:, 0]]
    _require(np.abs(stamps[idx] - res[:, 0]).max() < 1e-6, "keyframe stamps off the sequence's")
    ate = synthetic.ate_rmse(res[:, [4, 8, 12]], world.gt_t[idx])
    vio = np.loadtxt(os.path.join(log, "vio_poses.csv"), delimiter=",", ndmin=2)
    prof = open(os.path.join(log, "slam_profiler.txt")).read()
    expected = (n - 1) + len(slam_a.kf_traj)
    print(f"euroc: entry point: {loader} loader, {n} frames in {run_s:.1f} s, keyframes "
          f"{len(res)}, rolls {len(slam_a.archived_kf)}, vi_initialized "
          f"{slam_a.vi_initialized}, results.csv ATE {ate * 1e3:.3f} mm over {len(res)} "
          f"keyframes, vio_poses.csv {vio.shape[0]} rows x {vio.shape[1]} columns, median frame "
          f"{slam_a._prof.avg_ms('frame_total'):.2f} ms (profiled: every stage synchronised), "
          f"lk_track launches {launches} (frames - 1 + keyframes = {expected})")
    _require(ate < ATE_TOL_M, f"entry point ATE {ate:.4f} m")
    _require(slam_a.vi_initialized, "VIInit never fired on the entry point")
    _require(slam_a.n_resets == 0, "the entry point reset")
    # the bootstrap frame has no VIO row, as in the JAX package
    _require(vio.shape == (n - 1, 13), f"vio_poses.csv is {vio.shape}")
    _require("frame_total" in prof, "slam_profiler.txt lacks frame_total")
    _require(launches == expected, f"{launches} lk_track launches for {expected} tracks")

    # 2. a second uninterrupted run (saving a checkpoint at EUROC_SAVE_AT),
    # and a fresh instance resumed from the checkpoint
    slam_b, provider, _ = _euroc_build(cfg_main, data, device)
    it = provider.frames()
    slam_b.drive(itertools.islice(it, EUROC_SAVE_AT))
    ckpt = os.path.join(EUROC_DIR, "state.npz")
    checkpoint.save_slam(ckpt, slam_b)
    kf_pyr = slam_b.kf_pyr  # the tracking template is not in the file
    slam_b.drive(it)
    slam_c, provider, _ = _euroc_build(cfg_main, data, device)
    checkpoint.load_slam(ckpt, slam_c)
    slam_c.kf_pyr = kf_pyr
    slam_c.drive(itertools.islice(provider.frames(), EUROC_SAVE_AT, None))
    gap = float(np.abs(_positions(slam_a) - _positions(slam_b)).max())
    tol = max(gap, EUROC_RESUME_FLOOR_M)
    resume = float(np.abs(_positions(slam_c) - _positions(slam_b)).max())
    print(f"euroc: two uninterrupted runs part by {gap:.3e} m at most; the run resumed from "
          f"the frame-{EUROC_SAVE_AT} checkpoint ({os.path.getsize(ckpt)} B) parts from its "
          f"own by {resume:.3e} m (tolerance {tol:.3e} m: the gap, at least "
          f"{EUROC_RESUME_FLOOR_M:.0e} m)")
    _require(len(slam_c.traj) == len(frames), "the resumed run lost frames")
    _require(resume <= tol, f"resume parts by {resume:.3e} m > {tol:.3e} m")

    # 3. the full preset: multithreading on (the back end on a second
    # stream) against off, CLAHE through the loader
    ds_full = {}
    for mt in (1, 0):
        d = _euroc_config(EUROC_FULL_PRESET, f"full_mt{mt}", ds_yaml, multithreading=mt)
        slam, n_f, loader_f, s_f = run_euroc.replay(
            d, data, EUROC_FULL_FRAMES, device=device, log_dir=os.path.join(d, "log_slam"))
        ds_full[mt] = slam
        print(f"euroc: {EUROC_FULL_PRESET} multithreading={mt}: {loader_f} loader, "
              f"contrast_enhancer={slam.cfg.contrast_enhancer}, {n_f} frames in {s_f:.1f} s, "
              f"keyframes {len(slam.kf_traj)}, back-end steps on the side stream "
              f"{slam.backend_exec.steps if slam.backend_exec else 0}")
    _require(ds_full[1].backend_exec is not None and ds_full[1].backend_exec.steps > 0,
             "multithreading never used the side stream")
    _require(ds_full[1].cfg.contrast_enhancer == "clahe", "the full preset lost its CLAHE")
    mt_gap = float(np.abs(_positions(ds_full[1]) - _positions(ds_full[0])).max())
    print(f"euroc: multithreading on against off: positions part by {mt_gap:.3e} m "
          f"(tolerance {tol:.3e} m)")
    _require(mt_gap <= tol, f"multithreading parts by {mt_gap:.3e} m")

    # 4. clahe and remap of one frame, card against CPU
    calib = load_dataset_config(os.path.join(REPO, "configs", "euroc_bimonovio",
                                             "dataset.yaml")).cameras[0]
    grid = torch.as_tensor(euroc.undistort_grid(calib)[0])
    img = torch.as_tensor(frames[0].images[0]).float()
    rows = {}
    for name, fn in (("clahe", lambda x, g: euroc.clahe(x)),
                     ("remap", lambda x, g: euroc.remap(x, g))):
        cpu = fn(img, grid)
        gpu = fn(img.to(device), grid.to(device))
        err = float((gpu.cpu() - cpu).abs().max())
        rows[name] = err
        print(f"euroc: {name} on one {tuple(img.shape)} frame, card against CPU: max abs "
              f"{err:.3e} (tolerance {EUROC_IMG_TOL:.0e} intensity)")
        _require(err <= EUROC_IMG_TOL, f"{name}: card against CPU {err:.3e}")

    if measure:
        # 5. the prefetch: median process_frame ms with it on and off, in turns
        ms = {True: [], False: []}
        for on in (False, True, True, False):
            slam, provider, _ = _euroc_build(cfg_main, data, device)
            slam.prefetch = on
            times = _timed_frames(slam)
            slam.drive(provider.frames())
            ms[on].append(float(np.median(times)))
        print(f"euroc: median process_frame ms, prefetch on {ms[True]} / off {ms[False]} "
              f"(in turns off, on, on, off; {len(frames)} frames each)")
    shutil.rmtree(EUROC_DIR, ignore_errors=True)
    print(f"euroc: phase time {time.perf_counter() - t0:.1f} s")
    return {"lk_track": launches, "frames": n, "loader": loader, "gap": gap, "resume": resume,
            "mt_gap": mt_gap, "img_err": rows}


# --------------------------------------------------------------------------
# slice 7: the parallel modules, async_health, typed labels in the mono modes
# --------------------------------------------------------------------------

PAR_B = 8  # windows in the batched BA: the main path's last 8 window BAs
PAR_IMU_N = (10, 200)  # one 20 Hz frame's samples, a 1 s keyframe interval
# the IMU kernel against the plain loop: (samples, packed in IMU_CAP-row
# batches chained as StereoSLAM._accumulate_imu makes them, or one call)
PAR_KERNEL_CASES = ((1, True), (10, True), (32, True), (33, True), (200, True), (200, False))
PAR_KERNEL_TOL = 1e-5  # max |kernel - plain| / max |plain|, every Preintegration field
PAR_KERNEL_BIAS = ((0.05, -0.02, 0.03), (1e-3, 2e-3, -1e-3))  # ba, bg linearization point
PAR_SHARD_N = 256  # samples of the time-sharded preintegration over 2 ranks
PAR_RANKS = 2
PAR_T_TOL_M = 1e-4  # batched against separate solves, on t
PAR_DIR = os.path.join(REPO, ".smoke_parallel")  # git-ignored; removed after the phase
# tests/test_time_sharding.py:_check_equal's tolerances: (rtol, atol) per field;
# the covariance's atol is relative to its largest entry
PREINT_TOL = {"dR": (0.0, 3e-6), "dv": (0.0, 1e-5), "dp": (0.0, 1e-5), "dt": (0.0, 1e-6),
              "cov": (2e-4, 2e-4), **{f: (2e-4, 2e-6) for f in (
                  "J_dR_bg", "J_dv_ba", "J_dv_bg", "J_dp_ba", "J_dp_bg")}}
# tests/test_sharding.py's tolerances: t and R, landmarks, relative cost
SHARD_TOL = {"t": 1e-4, "R": 1e-4, "lmk": 1e-3, "cost": 1e-3}
TYPED_FRAMES = 40
TYPED_LABELS = ("linexd", "edgeletxd", "ellipsepatternxd", "bboxxd")

PAR_WORKER = r"""
import json, time
import torch
import torch.distributed as dist

rank, world, (d,) = join_group()  # defined ahead of this source by tests/torch_ranks.py
import chip_smoke as cs
from sadvio_tpu_torch.backend import ba
from sadvio_tpu_torch.models import imu
from sadvio_tpu_torch.parallel import sharding, time_sharding
from sadvio_tpu_torch.utils.struct import tree_map

dev = torch.device("cuda", 0)  # both ranks share the one card
inp = torch.load(f"{d}/inputs.pt", weights_only=False)
problem = tree_map(lambda x: x.to(dev), inp["problem"])
opts = inp["opts"]
mesh = sharding.make_mesh(world)
out = {}
for name, run in (("ba", lambda: sharding.ba_solve_sharded(problem, opts, mesh)),
                  ("imu", lambda: time_sharding.preintegrate_time_sharded(
                      *[x.to(dev) for x in inp["imu"]], imu.ImuParams.euroc(),
                      time_sharding.make_time_mesh(world)))):
    run()  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    out[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    out[name] = res
state, stats = out["ba"]
ref, ref_stats = ba.ba_solve(problem, opts)
km, lm = ref.kf_mask, ref.lmk_mask
err = {"t": float((state.t - ref.t)[km].abs().max()), "R": float((state.R - ref.R)[km].abs().max()),
       "lmk": float((state.lmk - ref.lmk)[lm].abs().max()),
       "cost": abs(float(stats["cost"]) / float(ref_stats["cost"]) - 1.0)}
seq = imu.preintegrate(*[x.to(dev) for x in inp["imu"]], imu.ImuParams.euroc())
res = {"rank": rank, "ba_ms": out["ba_ms"], "imu_ms": out["imu_ms"], "ba_err": err,
       "imu_excess": cs.preint_excess(out["imu"], seq), "t": state.t.cpu().tolist(),
       "cost": float(stats["cost"]), "ref_cost": float(ref_stats["cost"]),
       "accepted": stats["accepted"].cpu().tolist()}
with open(f"{d}/rank_{rank}.json", "w") as fh:
    json.dump(res, fh)
dist.destroy_process_group()
"""


def preint_excess(a, b):
    """max(|a - b| - (atol + rtol |b|)) per field at PREINT_TOL: <= 0 passes."""
    out = {}
    for f, (rtol, atol) in PREINT_TOL.items():
        x, y = getattr(a, f).double(), getattr(b, f).double()
        if f == "cov":
            atol = atol * float(y.abs().max())
        out[f] = float(((x - y).abs() - (atol + rtol * y.abs())).max())
    return out


def _event_host_ms(fn, reps=5):
    """Medians over reps of (device ms between CUDA events around fn, host ms
    to the end of its device work)."""
    dev, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    return float(np.median(dev)), float(np.median(host))


def _imu_kernel_vs_plain(acc, gyr, dt, device):
    """The IMU preintegration kernel (``imu.preintegrate`` on CUDA tensors)
    against its plain loop (``imu.preintegrate_ref``, on the card too) on the
    main world's samples, for each of PAR_KERNEL_CASES: the largest
    |kernel - plain| over the field's largest |plain| for every field; the
    device ms of both (``_graph_ms``: the kernel 50 times in one graph, the
    plain loop twice) and the host ms as Python calls them (``_event_host_ms``);
    and the host µs a call of the wrapper at the main path's 32-row batch."""
    from sadvio_tpu_torch.models import imu
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    cap, params = StereoSLAM.IMU_CAP, imu.ImuParams.euroc()
    ba, bg = (torch.tensor(b, device=device) for b in PAR_KERNEL_BIAS)
    pre0 = imu.Preintegration.identity(device=device).replace(ba_lin=ba, bg_lin=bg)
    fields = ("dR", "dv", "dp", "cov", "J_dR_bg", "J_dv_ba", "J_dv_bg", "J_dp_ba", "J_dp_bg",
              "dt")

    def pack(n, rows):  # the first n samples in `rows` rows, dt = 0 on the padding
        buf = np.zeros((rows, 7), np.float32)
        buf[:n, 0:3], buf[:n, 3:6], buf[:n, 6] = acc[:n], gyr[:n], dt[:n]
        return torch.as_tensor(buf, device=device)

    for n, packed in PAR_KERNEL_CASES:
        batches = (pack(n, -(-n // cap) * cap).reshape(-1, cap, 7) if packed
                   else pack(n, n)[None])

        def run(fn):
            pre = pre0
            for b in batches:
                pre = fn(b[:, 0:3], b[:, 3:6], b[:, 6], pre.ba_lin, pre.bg_lin, params, init=pre)
            return pre

        launches = imu.preintegrate.launches
        kern, plain = run(imu.preintegrate), run(imu.preintegrate_ref)
        _require(imu.preintegrate.launches - launches == len(batches),
                 f"imu kernel: {imu.preintegrate.launches - launches} launches for "
                 f"{len(batches)} batches")
        gaps = {}
        for f in fields:
            k, p = getattr(kern, f).double(), getattr(plain, f).double()
            gaps[f] = float((k - p).abs().max() / p.abs().max().clamp_min(1e-30))
        dev_k = _graph_ms(lambda: run(imu.preintegrate))
        dev_p = _graph_ms(lambda: run(imu.preintegrate_ref), n=2, reps=3)
        host_k = _event_host_ms(lambda: run(imu.preintegrate))[1]
        host_p = _event_host_ms(lambda: run(imu.preintegrate_ref))[1]
        worst = max(gaps, key=gaps.get)
        how = f"{len(batches)} x {cap} rows, chained" if packed else "one call"
        print(f"imu kernel: N={n} ({how}): worst field gap {gaps[worst]:.3e} ({worst}); "
              + ", ".join(f"{f} {g:.2e}" for f, g in gaps.items())
              + f"; device ms (graph replays) kernel {dev_k:.5f}, plain loop {dev_p:.3f}; host ms "
              f"as Python calls them kernel {host_k:.4f}, plain loop {host_p:.3f}")
        _require(gaps[worst] <= PAR_KERNEL_TOL, f"imu kernel N={n} ({how}): {gaps}")
    b = pack(10, cap)  # a frame's samples in one batch, as the main path calls it
    calls = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        imu.preintegrate(b[:, 0:3], b[:, 3:6], b[:, 6], ba, bg, params, init=pre0)
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    print(f"imu kernel: wrapper host {host_us:.1f} µs a call ({calls} calls of a {cap}-row "
          f"batch, enqueue only)")


def phase_parallel(main_rec, frames, device):
    """The parallel modules on the card: the IMU preintegration kernel
    against its plain loop on every field (``_imu_kernel_vs_plain``);
    preintegrate_assoc against preintegrate at N=10 and N=200 (the main
    world's IMU samples); the
    batched BA of the main path's last 8 window BAs (K=11, C=2, L=512, P=48)
    against 8 separate solves, timed in turns; and 2 ranks sharing the card
    (gloo over CUDA tensors): the landmark-sharded solve of the last window
    against the single-device solve, and the time-sharded preintegration
    at N=256 (the JAX test's stream) against the sequential one."""
    import importlib.util
    import shutil

    from sadvio_tpu_torch.backend import ba
    from sadvio_tpu_torch.models import imu
    from sadvio_tpu_torch.parallel import multiseq

    # tests/torch_ranks.py by its path: a site package named ``tests`` can
    # shadow the checkout's test folder
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(REPO, "tests", "torch_ranks.py"))
    torch_ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_ranks)

    cat = lambda key: np.concatenate([np.asarray(getattr(f, key), np.float32)
                                      for f in frames[1:]])
    acc, gyr, dt = cat("acc"), cat("gyr"), cat("dt")
    _imu_kernel_vs_plain(acc, gyr, dt, device)
    params = imu.ImuParams.euroc()
    slam = main_rec["slam"]
    z = torch.zeros(3, device=device)
    for n in PAR_IMU_N:
        a, g, h = (torch.as_tensor(x[:n], device=device) for x in (acc, gyr, dt))
        seq = imu.preintegrate(a, g, h, z, z, params)
        assoc = imu.preintegrate_assoc(a, g, h, z, z, params)
        excess = preint_excess(assoc, seq)
        t_seq = _event_host_ms(lambda: imu.preintegrate(a, g, h, z, z, params))
        t_assoc = _event_host_ms(lambda: imu.preintegrate_assoc(a, g, h, z, z, params))
        print(f"parallel: preintegration N={n}: sequential {t_seq[0]:.3f} ms device (events) / "
              f"{t_seq[1]:.3f} ms host, associative {t_assoc[0]:.3f} ms device / "
              f"{t_assoc[1]:.3f} ms host; worst excess over the tolerance "
              f"{max(excess.values()):.3e} ({max(excess, key=excess.get)})")
        _require(max(excess.values()) <= 0.0, f"parallel: preintegrate_assoc N={n}: {excess}")

    probs = list(main_rec["ba_problems"])
    _require(probs, "parallel: the main path ran no window BA")
    gen = torch.Generator(device=device).manual_seed(7)
    last = probs[-1]
    while len(probs) < PAR_B:  # seeded perturbations of the last window
        st = last.state
        noise = lambda x, s: x + s * torch.randn(x.shape, generator=gen, device=device)
        probs.append(last._replace(state=st.replace(t=noise(st.t, 0.01), lmk=noise(st.lmk, 0.02))))
    n_real = len(main_rec["ba_problems"])
    opts = slam._ba_opts
    batched = multiseq.stack_problems(probs)
    seq_states = [ba.ba_solve(p, opts)[0] for p in probs]
    bstate, _ = multiseq.ba_solve_batch(batched, opts)
    err = max(float((bstate.t[i] - s.t)[s.kf_mask].abs().max()) for i, s in enumerate(seq_states))
    times = {"separate": [], "batched": []}
    for name in ("separate", "batched", "batched", "separate"):
        fn = ((lambda: [ba.ba_solve(p, opts) for p in probs]) if name == "separate"
              else (lambda: multiseq.ba_solve_batch(batched, opts)))
        times[name].append(_event_host_ms(fn, reps=1))
    shape = tuple(probs[0].obs.mask.shape) + (probs[0].priors.P,)
    print(f"parallel: batched BA of {PAR_B} windows (K, C, L, P = {shape}, {n_real} from the "
          f"main path's last window BAs, {opts.iters} LM iterations): max |t - t_separate| "
          f"{err:.3e} m; in turns separate, batched, batched, separate: "
          + ", ".join(f"{k} {d:.1f} ms device / {h:.1f} ms host" for k in times
                      for d, h in times[k]))
    _require(err < PAR_T_TOL_M, f"parallel: batched BA off by {err:.3e} m")

    shutil.rmtree(PAR_DIR, ignore_errors=True)
    os.makedirs(PAR_DIR)
    try:
        torch.save({"problem": _to_cpu(last), "opts": opts,
                    "imu": _imu_stream(PAR_SHARD_N) + [torch.zeros(3), torch.zeros(3)]},
                   os.path.join(PAR_DIR, "inputs.pt"))
        t0 = time.perf_counter()
        torch_ranks.spawn(PAR_WORKER, PAR_RANKS, [PAR_DIR], PAR_DIR)
        spawn_s = time.perf_counter() - t0
        res = []
        for r in range(PAR_RANKS):
            with open(os.path.join(PAR_DIR, f"rank_{r}.json")) as fh:
                res.append(json.load(fh))
    finally:
        shutil.rmtree(PAR_DIR, ignore_errors=True)
    r0 = res[0]
    print(f"parallel: 2 ranks sharing one card (gloo, CUDA tensors; not a scaling number): "
          f"landmark-sharded BA {[round(r['ba_ms'], 1) for r in res]} ms per rank, errors "
          f"against the single-device solve {r0['ba_err']} (cost {r0['cost']:.6g} vs "
          f"{r0['ref_cost']:.6g}); time-sharded preintegration N={PAR_SHARD_N} "
          f"{[round(r['imu_ms'], 2) for r in res]} ms, worst excess over the tolerance "
          f"{max(r0['imu_excess'].values()):.3e}; spawn to exit {spawn_s:.1f} s")
    _require(all(r["t"] == r0["t"] and r["accepted"] == r0["accepted"] for r in res),
             "parallel: the ranks disagree")
    _require(all(r0["ba_err"][k] < SHARD_TOL[k] for k in SHARD_TOL),
             f"parallel: sharded BA off: {r0['ba_err']}")
    _require(max(r0["imu_excess"].values()) <= 0.0, f"parallel: time-sharded: {r0['imu_excess']}")
    return {"imu_n": PAR_IMU_N, "ba_err": err, "times": times, "ranks": res}


def _imu_stream(n, seed=0):
    """tests/test_time_sharding.py's stream (its tolerances were set on it):
    acc ~ N(0, 2) + gravity, gyr ~ N(0, 0.5), 200 Hz.  On the main world's
    IMU samples a small entry of J_dv_bg differs between the two float32
    summation orders by a little more than that test's atol."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    acc[:, 2] += 9.81
    gyr = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    return [torch.as_tensor(acc), torch.as_tensor(gyr), torch.full((n,), 1.0 / 200.0)]


def _to_cpu(problem):
    from sadvio_tpu_torch.utils.struct import tree_map

    return tree_map(lambda x: x.cpu(), problem)


def _async_run(world, frames, device, on):
    """The main path's config with async_health on or off, no synchronise
    between frames (the loop a user runs); each health read is timed."""
    from sadvio_tpu_torch.ops import klt_kernel
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    cfg = SLAMConfig(slam_mode="bimonovio", max_kf_number=10, min_lmk_number=40,
                     max_movement_parallax=1.0, min_movement_parallax=0.02, async_health=on,
                     caps=Capacities(**MAIN_CAPS))
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device=device)
    reads, read = [], slam._read_health

    def timed(fetch):
        t0 = time.perf_counter()
        h = read(fetch)
        reads.append((time.perf_counter() - t0) * 1e6)
        return h

    slam._read_health = timed
    klt_kernel.lk_track.launches = 0
    klt_kernel.lk_iterate.launches = 0
    torch.cuda.synchronize()
    ms, outs = [], []
    t_run = time.perf_counter()
    for f in frames:
        t0 = time.perf_counter()
        outs.append(slam.process_frame(f))
        ms.append((time.perf_counter() - t0) * 1e3)
    slam._flush_health()
    torch.cuda.synchronize()
    rec = {"on": on, "slam": slam, "run_s": time.perf_counter() - t_run, "frame_ms": np.asarray(ms),
           "reads_us": np.asarray(reads), "frames": len(frames),
           "is_kf": np.asarray([bool(o["is_kf"]) for o in outs]),
           "lags": sum(o.get("pose_ts", o["ts"]) != o["ts"] for o in outs),
           "lk_track": klt_kernel.lk_track.launches, "lk_iterate": klt_kernel.lk_iterate.launches}
    est = np.asarray([t for _, _, t in slam.traj])
    _require(len(est) == len(frames) and np.isfinite(est).all(), "async: one pose per frame expected")
    rec["ate"] = synthetic.ate_rmse(est, world.gt_t[: len(est)])
    return rec


def phase_async_health(world, frames, device):
    """The main path's 130 frames with async_health off and on, in turns
    (off, on, on, off): each reaches ATE < 50 mm with VIInit; keyframe
    frames, lagged frames, frame times and health-read times are printed,
    and no speed is gated."""
    recs = [_async_run(world, frames, device, on) for on in (False, True, True, False)]
    for r in recs:
        kf = np.flatnonzero(r["is_kf"]).tolist()
        tag = "on " if r["on"] else "off"
        print(f"async_health {tag}: ATE {r['ate'] * 1e3:.3f} mm, VIInit "
              f"{r['slam'].vi_initialized}, keyframe frames {kf}, lagged frames {r['lags']}, "
              f"median frame {np.median(r['frame_ms']):.2f} ms (tracking frames "
              f"{np.median(r['frame_ms'][~r['is_kf']]):.2f} ms), run {r['run_s']:.2f} s, health "
              f"reads {len(r['reads_us'])}: median {np.median(r['reads_us']):.1f} us, p90 "
              f"{np.percentile(r['reads_us'], 90):.1f} us, launches lk_track={r['lk_track']}")
        _require(r["ate"] < ATE_TOL_M, f"async_health {tag}: ATE {r['ate']:.4f} m")
        _require(r["slam"].vi_initialized, f"async_health {tag}: VIInit never fired")
        _require(r["slam"].n_resets == 0, f"async_health {tag}: the run reset")
        _require(r["lk_track"] == (r["frames"] - 1) + int(r["is_kf"].sum())
                 and r["lk_iterate"] == 0, f"async_health {tag}: {r['lk_track']} lk_track launches")
        _require((r["lags"] > 0) == r["on"], f"async_health {tag}: {r['lags']} lagged frames")
    same = all((r["is_kf"] == recs[0]["is_kf"]).all() for r in recs)
    print(f"async_health: keyframe frames the same in all four runs: {same}")
    return recs


def phase_typed_modes(world, frames, device):
    """Typed labels in the monocular classes: configs/euroc_mono with every
    label on camera 0 of the main world with the coded pattern stamped (only
    the ellipse channel builds with one camera), 40 frames, Sim3 ATE < 80 mm;
    configs/nofov at phase_nofov's settings with every label (all four
    channels build), 40 frames, tail segment scale within 0.75-1.3."""
    from sadvio_tpu_torch.pipeline.config import FeatureConfig
    from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM

    feats = (FeatureConfig(),) + tuple(FeatureConfig(label=lb, pattern_side=PATTERN_SIDE)
                                       for lb in TYPED_LABELS)
    stamped = [f._replace(images=_stamp_pattern(world, i, f.images[0])[None])
               for i, f in enumerate(frames[:TYPED_FRAMES])]
    mono = run_mono(world, stamped, device, "euroc_mono", False, features=feats)
    held = lambda slam: {type(c).__name__: int(c.mask.sum()) for c in slam.channels}
    pid = mono["slam"].channels[0].patterns()[0].tolist() if mono["slam"].channels else []
    _mode_summary("typed mono", mono, f" | Sim3 ATE {mono['ate_sim3'] * 1e3:.3f} mm, channels "
                  f"{held(mono['slam'])}, pattern ids {pid}")
    _require([type(c).__name__ for c in mono["slam"].channels] == ["EllipseChannel"],
             "typed mono: one camera builds the ellipse channel only")
    _require(mono["ate_sim3"] < MONO_ATE_TOL_M, f"typed mono: Sim3 ATE {mono['ate_sim3']:.4f} m")

    nw, nframes = make_nofov_world(device, TYPED_FRAMES)
    slam = NoFovSLAM(nw.rig, preset_config("nofov", max_movement_parallax=NOFOV_MAX_PARALLAX,
                                           features=feats), device=device)
    nofov = _drive_mode(slam, nframes)
    seg = lambda p: np.linalg.norm(np.diff(p[-NOFOV_TAIL:], axis=0), axis=-1).sum()
    tail = float(seg(nofov["est"]) / max(seg(nw.gt_t[: nofov["frames"]]), 1e-9))
    _mode_summary("typed nofov", nofov, f" | tail segment scale {tail:.4f}, scale applied "
                  f"{slam.scale_state['applied']}, channels {held(slam)}")
    _require(len(slam.channels) == 4, "typed nofov: the four channels were not built")
    _require(0.75 < tail < 1.3, f"typed nofov: tail scale {tail:.3f}")
    _require(slam.n_resets == 0, "typed nofov: the run reset")
    return {"mono": mono, "nofov": nofov}


# --------------------------------------------------------------------------
# the biased and the hardened worlds

# tests/test_pipeline_stress.py's biases, rotation and gates; 130 frames as
# the main path (the JAX test's 40 at 320x240 hold K=6, the main path K=11)
STRESS_GYR_BIAS = (0.02, -0.015, 0.01)  # rad/s
STRESS_ACC_BIAS = (0.05, 0.04, -0.06)  # m/s^2
STRESS_ROT_SCALE = 4.0
STRESS_BIAS_FRAMES, STRESS_HARD_FRAMES = 130, 80
STRESS_BIAS_ATE_TOL_M, STRESS_BG_TOL, STRESS_BA_TOL = 0.06, 0.01, 0.15
STRESS_HARD_ATE_TOL_M = 0.08
STRESS_HARDENING = dict(noise_px=2.0, gain_jitter=0.12, offset_jitter=8.0, occluder=True)
STRESS_MIN_UNDER = 8  # live features under the occluder at the frame the kernel is held on


def _gate_rejects(call):
    """Of one frame track's live features (valid0): the share the forward-
    backward gate rejects and the share the max_err gate rejects, each
    against the same track with that gate open, and the count valid with
    both gates (four lk_track calls)."""
    from sadvio_tpu_torch.ops import klt_kernel

    (pyr0, pyr1, uv0, init, valid0), k = call
    kw = dict(levels=k["levels"], radius=k["radius"])
    run = lambda fb, err: klt_kernel.lk_track(pyr0, pyr1, uv0, init, valid0, k["warp"], **kw,
                                              fb_thresh=fb, max_err=err)[1]
    inf = float("inf")
    open_, fb_only, err_only = run(inf, inf), run(FB_THRESH, inf), run(inf, MAX_ERR)
    live = max(int(valid0.sum()), 1)
    return (int((open_ & ~fb_only).sum()) / live, int((open_ & ~err_only).sum()) / live,
            int(run(FB_THRESH, MAX_ERR).sum()))


def _against_clean(call, f, kf_f, hframes, device):
    """The hardened frame track against the same call on clean images.  The
    hardened world without its knobs renders the same frames, so the
    control keeps the slots, starts, warps and valid0 of the call and
    changes only the images.  Device ms of both by graph replay in turns,
    and the iterations per tracked slot and per live slot and the slowest
    slot's SM cycles that the counters of the -DLK_CLOCKS library give."""
    from sadvio_tpu_torch.frontend import klt
    from sadvio_tpu_torch.ops import klt_kernel

    (pyr0, pyr1, uv0, init, valid0), k = call
    levels = k["levels"]
    img = lambda frames, g: torch.as_tensor(frames[g].images[0], device=device).float()
    _require(torch.equal(pyr0[0], img(hframes, kf_f)) and torch.equal(pyr1[0], img(hframes, f)),
             "stress hardened: the captured track is not keyframe -> frame of camera 0")
    _, clean = make_world(device, f + 1)  # the images do not depend on the frame count
    pyrs = {"hardened": (pyr0, pyr1),
            "clean": tuple(klt.build_pyramid(img(clean, g), levels) for g in (kf_f, f))}
    args = (uv0.contiguous(), init.contiguous(), valid0.contiguous(), k["warp"].contiguous())
    tracked = (torch.isfinite(uv0).all(1) & torch.isfinite(init).all(1)).cpu().numpy()
    live = valid0.cpu().numpy()
    kw = dict(levels=levels, radius=k["radius"])
    out, runs = {"tracked": int(tracked.sum()), "live": int(live.sum())}, {}
    for name, (p0, p1) in pyrs.items():
        runs[name] = lambda p0=p0, p1=p1: klt_kernel.lk_track(p0, p1, *args, **kw)
        klt_kernel.lk_track_clocks(p0, p1, *args, **kw)  # builds the counting library, warms it
        ck = klt_kernel.lk_track_clocks(p0, p1, *args, **kw).numpy()
        out[f"{name}_iterations_tracked"] = float(ck[tracked, 5].mean())
        out[f"{name}_iterations_live"] = float(ck[live, 5].mean())
        out[f"{name}_cycles_max"] = int(ck[:, 3].max())
        out[f"{name}_valid"] = int(runs[name]()[1].sum())
    ms = {"clean": [], "hardened": []}
    for name in ("clean", "hardened", "hardened", "clean"):
        ms[name].append(_graph_ms(runs[name]))
    out.update({f"{k}_ms": float(np.mean(v)) for k, v in ms.items()})
    print(f"kernel lk_track: hardened frame against the same call on the clean world's images "
          f"(same {out['tracked']} tracked slots, {out['live']} live), in turns: device "
          f"{out['hardened_ms']:.5f} / {out['clean_ms']:.5f} ms; valid after the track "
          f"{out['hardened_valid']} / {out['clean_valid']}; iterations per tracked slot "
          f"{out['hardened_iterations_tracked']:.2f} / {out['clean_iterations_tracked']:.2f}, "
          f"per live slot {out['hardened_iterations_live']:.2f} / "
          f"{out['clean_iterations_live']:.2f}; slowest slot {out['hardened_cycles_max']} / "
          f"{out['clean_cycles_max']} SM cycles")
    return out


class _KeepViInit:
    """Keep the inputs, the window slots' timestamps and the answer of every
    VIInit attempt while a run goes (the pipeline calls viinit.vi_init
    through the module); the originals are put back on exit."""

    def __enter__(self):
        from sadvio_tpu_torch.backend import viinit
        from sadvio_tpu_torch.pipeline.slam import StereoSLAM

        self.calls, slot_ts = [], []
        solve, attempt = viinit.vi_init, StereoSLAM._run_vi_init
        self.undo = [(viinit, "vi_init", solve), (StereoSLAM, "_run_vi_init", attempt)]

        def vi_init(R, t, kf_mask, imu_chain, **k):
            res = solve(R, t, kf_mask, imu_chain, **k)
            self.calls.append(dict(args=(R.clone(), t.clone(), kf_mask.clone(), imu_chain),
                                   kw=k, res=res, slot_ts=list(slot_ts)))
            return res

        def run_vi_init(slam):
            slot_ts[:] = slam.kf_ts
            return attempt(slam)

        viinit.vi_init, StereoSLAM._run_vi_init = vi_init, run_vi_init
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self.undo:
            setattr(obj, name, orig)


def _frame_rotation(R_est, R_gt):
    """The rotation that takes the true world to the estimated one, fitted
    over pairs of body-to-world rotations (R_est_i ~ R_c R_gt_i)."""
    M = np.einsum("nij,nkj->ik", np.asarray(R_est, np.float64), np.asarray(R_gt, np.float64))
    U, _, Vt = np.linalg.svd(M)
    return U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt


def _tilt(g_dir, R_c):
    """Angle (rad) between an estimated gravity direction and the true one
    (-z of the true world) seen in the estimated world."""
    g_true = R_c @ np.array([0.0, 0.0, -1.0])
    g_dir = np.asarray(g_dir, np.float64) / np.linalg.norm(g_dir)
    return float(np.arccos(np.clip(g_dir @ g_true, -1.0, 1.0)))


def _bias_witness(rec, keep_vi, world, vi, ab):
    """Where |ba - true| comes from.  The accelerometer bias is seen only
    beside gravity: a gravity direction off by a tilt theta is absorbed by
    a bias error of about g*theta.  Of the accepted VIInit attempt: |ba -
    true| and g*tilt on the run's own poses, and on the true poses of the
    same keyframes with the same IMU chain; |ba - true| on the run's poses
    with every IMU link on (the >1 s gap gate off); then the estimates
    after it (one per keyframe) and g*tilt of the final map, fitted over the
    frames after VIInit.  Returns those numbers and the accepted attempt's
    window poses, keyframe mask and IMU chain as numpy arrays."""
    from sadvio_tpu_torch.backend import viinit
    from sadvio_tpu_torch.models import imu as imu_mod

    slam = rec["slam"]
    g = imu_mod.GRAVITY
    att = keep_vi.calls[-1]
    (R, t, kf_mask, chain), res = att["args"], att["res"]
    frame_of = {f.ts: i for i, f in enumerate(world.frames)}
    kf = [frame_of[ts] for ts in att["slot_ts"]]
    n = len(kf)
    _require(bool(kf_mask[:n].all()) and not bool(kf_mask[n:].any()),
             "stress bias: VIInit's slots and keyframe stamps disagree")
    traj_R = np.stack([r for _, r, _ in slam.traj])
    R_vis = _frame_rotation(traj_R[:vi], world.gt_R[:vi])
    ba_err = lambda b: float(np.linalg.norm(b.cpu().numpy() - ab))
    own = (ba_err(res["ba"]), g * _tilt(res["g_dir"].cpu().numpy(), R_vis))
    every = torch.arange(len(chain.mask), device=kf_mask.device) < n - 1
    own_every = ba_err(viinit.vi_init(R, t, kf_mask, chain.replace(mask=every), **att["kw"])["ba"])
    R_gt, t_gt = R.clone(), t.clone()
    R_gt[:n] = torch.as_tensor(world.gt_R[kf], device=R.device)
    t_gt[:n] = torch.as_tensor(world.gt_t[kf], device=t.device)
    true_res = viinit.vi_init(R_gt, t_gt, kf_mask, chain, **att["kw"])
    true = (ba_err(true_res["ba"]), g * _tilt(true_res["g_dir"].cpu().numpy(), np.eye(3)))
    rows = np.asarray(slam.vio_log)
    ba_rows = rows[:, 7:10]
    changed = np.flatnonzero(np.any(np.diff(ba_rows, axis=0) != 0, axis=1)) + 1
    history = [float(np.linalg.norm(ba_rows[i] - ab)) for i in changed]
    R_fin = _frame_rotation(traj_R[vi:], world.gt_R[vi:])
    final_tilt = g * float(np.arccos(np.clip(R_fin[2, 2], -1.0, 1.0)))
    print(f"stress bias: |ba - true| and g*tilt of gravity, m/s^2: VIInit on the run's poses "
          f"{own[0]:.4f} / {own[1]:.4f} ({int(chain.mask.sum())} of {n - 1} IMU links on; "
          f"with every link {own_every:.4f}); VIInit on the true poses of the same {n} "
          f"keyframes (frames {kf}) {true[0]:.4f} / {true[1]:.4f}; estimates after VIInit "
          f"{[round(x, 4) for x in history]}; final map g*tilt {final_tilt:.4f}")
    inputs = {"R": R, "t": t, "kf_mask": kf_mask, "mask": chain.mask,
              **{f"pre_{k.name}": getattr(chain.pre, k.name)
                 for k in dataclasses.fields(chain.pre)}}
    return ({"vi_own": own, "vi_own_every_link": own_every, "vi_true_poses": true,
             "vi_keyframes": kf, "history": history, "final_g_tilt": final_tilt},
            {k: v.cpu().numpy() for k, v in inputs.items()})


def phase_stress(device):
    """Nonzero IMU bias and the hardened world at the main path's settings.

    Biased: the main world with rot_scale 4 and tests/test_pipeline_stress.py's
    gyro and accelerometer biases, 130 frames; VIInit fires, ATE < 60 mm,
    |bg - true| < 0.01 rad/s and |ba - true| < 0.15 m/s^2 at the newest
    keyframe (the JAX test's gates).  Hardened: the main world with pixel
    noise 2, exposure flicker (gain +-12%, offset +-8) and the occluder, 80
    frames; no reset, ATE < 80 mm; per frame track the share of live
    features the forward-backward and the max_err gates reject.  Then
    lk_track against lk_track_ref on the inputs of the frame track with the
    largest exposure step between its two images (mean intensity outside
    the occluder) among those where the occluder covers the starts of at
    least STRESS_MIN_UNDER live features and more than N/8 features stay
    valid (_track_kernel_row)."""
    from sadvio_tpu_torch.pipeline import synthetic

    t0 = time.perf_counter()
    gb, ab = np.asarray(STRESS_GYR_BIAS), np.asarray(STRESS_ACC_BIAS)
    world, frames = make_world(device, STRESS_BIAS_FRAMES, rot_scale=STRESS_ROT_SCALE,
                               gyr_bias=gb, acc_bias=ab)
    with _KeepViInit() as keep_vi:
        rec = run_slam(world, frames, device, "fused")
    slam = rec["slam"]
    k = slam.n_kf - 1
    bg_err = float(np.linalg.norm(slam.window.bg[k].cpu().numpy() - gb))
    ba_err = float(np.linalg.norm(slam.window.ba[k].cpu().numpy() - ab))
    vi = next((i for i, o in enumerate(rec["outs"]) if o.get("vi_initialized")), None)
    kf = np.flatnonzero(rec["is_kf"]).tolist()
    print(f"stress bias: {_describe(rec)}")
    print(f"stress bias: VIInit at frame {vi}, ATE {rec['ate'] * 1e3:.3f} mm, |bg - true| "
          f"{bg_err:.5f} rad/s, |ba - true| {ba_err:.4f} m/s^2, keyframe frames {kf}, resets "
          f"{slam.n_resets}, lk_track launches {rec['lk_track']}, keyframe median "
          f"{np.median(rec['frame_ms'][rec['is_kf']]):.1f} ms")
    _require(slam.vi_initialized, "stress bias: VIInit never fired")
    _require(rec["ate"] < STRESS_BIAS_ATE_TOL_M, f"stress bias: ATE {rec['ate']:.4f} m")
    _require(bg_err < STRESS_BG_TOL, f"stress bias: |bg - true| {bg_err:.4f}")
    _require(ba_err < STRESS_BA_TOL, f"stress bias: |ba - true| {ba_err:.4f}")
    _require(slam.n_resets == 0 and rec["lk_track"] == _accounted_tracks(rec)
             and rec["lk_iterate"] == 0, f"stress bias: {rec['lk_track']} lk_track launches")
    witness, vi_inputs = _bias_witness(rec, keep_vi, world, vi, ab)

    hworld, hframes = make_world(device, STRESS_HARD_FRAMES, **STRESS_HARDENING)
    with _CaptureTrack() as keep:
        hrec = run_slam(hworld, hframes, device, "fused")
    hslam = hrec["slam"]
    print(f"stress hardened: {_describe(hrec)}, keyframe median "
          f"{np.median(hrec['frame_ms'][hrec['is_kf']]):.1f} ms")
    _require(hslam.n_resets == 0, "stress hardened: the run reset")
    _require(hrec["ate"] < STRESS_HARD_ATE_TOL_M, f"stress hardened: ATE {hrec['ate']:.4f} m")
    _require(hrec["lk_track"] == _accounted_tracks(hrec) and hrec["lk_iterate"] == 0,
             f"stress hardened: {hrec['lk_track']} lk_track launches")
    _require(len(keep.calls) == len(hframes) - 1, "stress hardened: one frame track per frame")
    rejects = np.asarray([_gate_rejects(c) for c in keep.calls])
    print("stress hardened: rejected share of live features per frame track (frames 1..): "
          f"forward-backward {np.round(rejects[:, 0], 3).tolist()}; max_err "
          f"{np.round(rejects[:, 1], 3).tolist()}; mean {rejects[:, 0].mean():.4f} / "
          f"{rejects[:, 1].mean():.4f}, max {rejects[:, 0].max():.4f} / {rejects[:, 1].max():.4f}")
    _require(rejects[:, 0].max() > 0, "stress hardened: the forward-backward gate never fired")

    T = len(hframes)
    H, W = hframes[0].images.shape[1:]
    kf_frames = np.flatnonzero(hrec["is_kf"])
    best = None
    for i, call in enumerate(keep.calls):
        f = i + 1
        kf_f = int(kf_frames[kf_frames < f].max())
        cx, cy, r = synthetic.occluder_disc(f, T, W, H)
        if not (-r < cx < W + r and -r < cy < H + r):
            continue
        clear = ~(synthetic.occluder_mask(f, T, W, H) | synthetic.occluder_mask(kf_f, T, W, H))
        a, b = (hframes[g].images[0][clear].astype(np.float64).mean() for g in (kf_f, f))
        step = abs(np.log(b / a))
        (_, _, _, init, valid0), _ = call
        under = valid0 & (((init - torch.tensor([cx, cy], device=device)) ** 2).sum(1) < r * r)
        # enough features left valid for _track_kernel_row's agreement check
        key = (int(under.sum()) >= STRESS_MIN_UNDER and rejects[i, 2] > N_FEATURES // 8, step)
        if best is None or key > best[0]:
            best = (key, f, kf_f, call, under)
    _require(best is not None, "stress hardened: the occluder never crossed the image")
    (_, step), f, kf_f, call, under = best
    (pyr0, pyr1, uv0, init, valid0), kw = call
    print(f"kernel lk_track: hardened frame track: frame {f} from keyframe {kf_f}, mean "
          f"intensity step {np.exp(step):.4f}x outside the occluder, {int(valid0.sum())} live "
          f"features, {int(under.sum())} of them start under the occluder")
    row = _track_kernel_row("hardened frame", pyr0, pyr1, uv0.contiguous(), init.contiguous(),
                            valid0.contiguous(), kw["warp"].contiguous(), 1, LEVELS, under=under)
    row.update(frame=f, step=float(np.exp(step)), under=int(under.sum()),
               launches=hrec["lk_track"], **_against_clean(call, f, kf_f, hframes, device))
    print(f"stress: phase time {time.perf_counter() - t0:.1f} s")
    return {"bias": rec, "hardened": hrec, "rejects": rejects, "row": row, "vi_frame": vi,
            "bg_err": bg_err, "ba_err": ba_err, "witness": witness, "vi_inputs": vi_inputs}


SHAPE_KEYS = ("ms", "profiler_ms", "host_us", "plain_ms", "bound_ms", "bound_by", "max_abs_err_uv",
              "max_abs_err_err")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import sadvio_tpu_torch  # noqa: F401  (pins full fp32)

    measure = "--measure" in sys.argv[1:]
    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = phase_env()
    phase_build()
    world, frames = make_world(device, N_FRAMES)
    probes = []
    t_phase = [time.perf_counter()]

    def probe(after):
        print(f"phase time: {after} {time.perf_counter() - t_phase[0]:.1f} s")
        phase_profiler_probe(after, frames, device, probes)
        t_phase[0] = time.perf_counter()

    it_rows = phase_kernel(frames[0], device)
    probe("phase_kernel")
    tr_rows = phase_track_kernel(frames, device)
    probe("phase_track_kernel")
    fused = phase_main_path(world, frames, device)
    probe("phase_main_path")
    phase_graphs(world, frames, device, fused)
    probe("phase_graphs")
    levels = phase_levels_path(world, frames, device, fused)
    probe("phase_levels_path")
    fronts = phase_frontends(world, frames, device, fused)
    probe("phase_frontends")
    long_rec = phase_long_run(device)
    probe("phase_long_run")
    phase_marg_backends(long_rec, device)
    probe("phase_marg_backends")
    mono = phase_mono(world, frames, device, vio=False)
    probe("phase_mono(mono)")
    mode_rows = {"mono_frame": phase_mono_kernel(mono)}
    probe("phase_mono_kernel")
    monovio = phase_mono(world, frames, device, vio=True)
    probe("phase_mono(monovio)")
    nofov = phase_nofov(device)
    probe("phase_nofov")
    mode_rows["nofov_refine"] = phase_nofov_kernel(nofov)
    probe("phase_nofov_kernel")
    exotic = phase_exotic(device)
    probe("phase_exotic")
    lines = phase_lines(device)
    probe("phase_lines")
    chans = phase_channels(device, probe)
    probe("phase_channels")
    desc = phase_descriptors(frames[0], device)
    probe("phase_descriptors")
    euroc_rec = phase_euroc(world, frames, device, measure=measure)
    probe("phase_euroc")
    phase_parallel(fused, frames, device)
    probe("phase_parallel")
    async_recs = phase_async_health(world, frames, device)
    probe("phase_async_health")
    typed = phase_typed_modes(world, frames, device)
    probe("phase_typed_modes")
    stress = phase_stress(device)
    mode_rows["hardened_frame"] = stress["row"]
    probe("phase_stress")
    lost = [after for after, seen, _ in probes if not seen]
    print(f"profiler probe: lk_track recorded after {sum(seen for _, seen, _ in probes)} of "
          f"{len(probes)} phases; first phase after which it was not: "
          f"{lost[0] if lost else 'none'}")
    if measure:
        phase_stage_kernels(long_rec)
        phase_clocks(frames, device)
        phase_measure(world, frames, device)
    if "--sweep" in sys.argv[1:]:
        phase_long_sweep(device)
    if "--save-vi-init" in sys.argv[1:]:
        np.savez(sys.argv[sys.argv.index("--save-vi-init") + 1], **stress["vi_inputs"])
    if "--parent" in sys.argv[1:]:
        phase_parent(sys.argv[sys.argv.index("--parent") + 1], frames[0], device)
    print(f"descriptors: {json.dumps(desc)}")
    print(f"command time: {time.perf_counter() - t_start:.1f} s (build and every phase)")
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
        "launches_line_run": lines["lk_track"],
        "launches_channel_runs": {k: r["lk_track"] for k, r in chans.items()},
        "launches_euroc_run": euroc_rec["lk_track"],
        "launches_async_runs": {("on" if r["on"] else "off") + str(i): r["lk_track"]
                                for i, r in enumerate(async_recs)},
        "launches_typed_runs": {k: r["lk_track"] for k, r in typed.items()},
        "launches_stress_runs": {k: stress[k]["lk_track"] for k in ("bias", "hardened")},
        "hardened_frame": {k: stress["row"][k] for k in (
            *SHAPE_KEYS, "bound_tracked_ms", "tracked", "live", "frame", "step", "under",
            "hardened_ms", "clean_ms", "hardened_iterations_tracked",
            "clean_iterations_tracked")},
        "bias_witness": stress["witness"],
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
