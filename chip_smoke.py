#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the LK kernels from
the sources in this checkout, checks each against its plain PyTorch version
at the main path's shapes, then drives the flagship stereo-VIO main path
(``StereoSLAM(rig, cfg, imu_params).run``) at EuRoC shapes and checks the
trajectory against ground truth.

    python3 chip_smoke.py             # the whole check
    python3 chip_smoke.py --measure   # adds lk_track's cycles per phase, the
                                      # end-to-end comparison of the two KLT
                                      # engines, the stage tables and the
                                      # kernels-per-frame count
    python3 chip_smoke.py --parent DIR  # adds lk_iterate of the checkout
                                        # unpacked under DIR, timed in turns

Phases: environment; build; ``lk_iterate`` against ``lk_iterate_ref`` on the
four pyramid levels; ``lk_track`` against ``lk_track_ref`` and against the
five-launch ``track(engine="levels")`` in the frame-track and stereo-track
call shapes; the 130-frame main path on ``engine="fused"``; the first 30
frames again on ``engine="levels"``.  No phase catches its own failure.

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
import subprocess
import sys
import time

import numpy as np
import torch

N_FEATURES = 512  # landmark slots L of the main path
RADIUS = 5  # KLT radius: 11 x 11 patches
LEVELS = 4
N_FRAMES = 130  # VIInit fires and the window rolls within this run
N_FRAMES_LEVELS = 30  # the earlier per-level engine's short path
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
    (count, self device us)}, wall seconds)."""
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
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key] = (e.count, float(e.self_device_time_total))
    _require(out, "torch.profiler recorded no device time")
    return out, wall


def _kernel_self_ms(table, name, calls):
    """Self device ms per call of the kernels whose name contains `name`."""
    hit = [(c, us) for k, (c, us) in table.items() if name in k]
    _require(hit, f"profiler saw no kernel named {name}")
    return sum(us for _, us in hit) / calls / 1e3


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


def bound_lk_track(pyr0, pyr1, uv0, uv_init, valid0, warp, bwd_levels):
    N, S = uv0.shape[0], 2 * RADIUS + 1
    ins = [*pyr0, *pyr1, uv0, uv_init, valid0] + ([] if warp is None else [warp])
    passes = [ITERS if lvl == 0 else ITERS_COARSE for lvl in range(LEVELS)]
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


def make_world(device, n_frames):
    from sadvio_tpu_torch.pipeline import synthetic

    world = synthetic.make_world(seed=5, n_frames=n_frames, width=752, height=480,
                                 n_points=400, imu_noise=True, device=device)
    frames = [f._replace(images=np.clip(f.images, 0, 255).astype(np.uint8))
              for f in world.frames]
    return world, frames


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
    0 -> camera 1 of one frame, identity warp, start at uv0."""
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
    return pyr0, pyr1, t(uv0_h.astype(np.float32)), t(init), t(valid_h), t(warp), 1


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def phase_track_kernel(frames, device):
    """lk_track vs lk_track_ref and vs track(engine="levels") on the card,
    in the frame-track and the stereo-track call shapes; times of all three
    taken in turns."""
    from sadvio_tpu_torch.frontend import klt
    from sadvio_tpu_torch.ops import klt_kernel

    rows = []
    for shape in ("frame", "stereo"):
        pyr0, pyr1, uv0, init, valid0, warp, bwd = _track_inputs(frames, device, shape)
        kw = dict(levels=LEVELS, radius=RADIUS, iters=ITERS, iters_coarse=ITERS_COARSE,
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
            _require(ties <= N_FEATURES // 100, f"{shape}: {ties} gate ties against {name}")
            both = v_k & v_o
            _require(int(both.sum()) > N_FEATURES // 8, f"{shape}: {int(both.sum())} valid")
            d_uv = float((uv_k[both] - uv_o[both]).abs().max())
            d_err = float((e_k[both] - e_o[both]).abs().max())
            nan_rows = int(torch.isnan(uv_k).any(1).sum())
            print(f"kernel lk_track: {shape} track vs {name}: valid in both {int(both.sum())} "
                  f"of {N_FEATURES}, gate ties {ties}, NaN rows {nan_rows}, "
                  f"max|duv|={d_uv:.3e} px max|derr|={d_err:.3e}")
            _require(d_uv < UV_TOL_PX and d_err < ERR_TOL,
                     f"{shape}: lk_track disagrees with {name}")
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
               "profiler_ms": _kernel_self_ms(tab_k, "lk_track_kernel", n_prof),
               "python_loop_ms": _loop_ms(run_k), "host_us": _host_us(run_k),
               "plain_ms": float(np.mean(ms_r)),
               "levels_python_loop_ms": float(np.mean(ms_l)),
               "levels_device_ms": sum(us for _, us in tab_l.values()) / n_prof / 1e3,
               "levels_lk_iterate_device_ms": _kernel_self_ms(tab_l, "lk_iterate_kernel", n_prof),
               "levels_kernels": sum(c for c, _ in tab_l.values()) / n_prof,
               "levels_host_us": _host_us(run_l, n=20),
               **bound_lk_track(pyr0, pyr1, uv0, init, valid0, warp, bwd)}
        rows.append(row)
        print(f"kernel lk_track: {shape} track N={N_FEATURES} S={2 * RADIUS + 1} levels={LEVELS} "
              f"| fused: device {row['ms']:.5f} ms (graph of {GRAPH_LAUNCHES}), profiler self "
              f"{row['profiler_ms']:.5f} ms, as Python launches it {row['python_loop_ms']:.4f} ms, "
              f"host {row['host_us']:.1f} us/call | engine=levels: {row['levels_kernels']:.0f} "
              f"kernels, device {row['levels_device_ms']:.4f} ms (profiler, all kernels; "
              f"lk_iterate alone {row['levels_lk_iterate_device_ms']:.5f} ms), as Python launches "
              f"it {row['levels_python_loop_ms']:.3f} ms, host {row['levels_host_us']:.0f} us/call "
              f"| plain {row['plain_ms']:.2f} ms | bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']} ({row['bytes']} B, {row['flop']} FLOP at the cap)")
    return rows


MAIN_CAPS = dict(K=11, L=512, P=48, pyr_levels=LEVELS, klt_radius=RADIUS)
STAGES = ("_pyramids", "_accumulate_imu", "_frontend", "_insert_kf", "_template_cache",
          "_backend", "_marg_roll", "_run_vi_init")


def _time_stages(slam):
    """Wrap the pipeline's stages with a synchronised host clock; returns
    {stage: [ms, ...]} filled as the run goes."""
    log = {name: [] for name in STAGES}

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    for name in STAGES:
        setattr(slam, name, wrap(name, getattr(slam, name)))
    return log


def run_slam(world, frames, device, engine, caps=MAIN_CAPS, stages=False, profile_frames=()):
    """Drive StereoSLAM over `frames` on `engine`; returns the run's record.
    Launch counts are set to 0 just before the first frame and read just
    after the last.  `profile_frames` (first, last) puts torch.profiler
    around those frames."""
    from sadvio_tpu_torch.ops import klt_kernel
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    cfg = SLAMConfig(slam_mode="bimonovio", max_kf_number=10, min_lmk_number=40,
                     max_movement_parallax=1.0, min_movement_parallax=0.02,
                     async_health=False,
                     caps=Capacities(**caps))
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device=device)
    slam.klt_engine = engine
    stage_log = _time_stages(slam) if stages else None
    klt_kernel.lk_iterate.launches = 0
    klt_kernel.lk_track.launches = 0
    frame_ms, is_kf, prof = [], [], None
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
        if profile_frames and i == profile_frames[1]:
            prof_wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
    run_s = time.perf_counter() - t_run
    rec = {"engine": engine, "slam": slam, "frames": len(frames), "run_s": run_s,
           "frame_ms": np.asarray(frame_ms), "is_kf": np.asarray(is_kf),
           "lk_iterate": klt_kernel.lk_iterate.launches, "lk_track": klt_kernel.lk_track.launches,
           "stages": stage_log}
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
    # one frame track per frame after the first, one stereo track per keyframe
    _require(slam.n_resets == 0, "the main path reset")
    tracks = (len(frames) - 1) + int(rec["is_kf"].sum())
    _require(rec["lk_track"] == tracks,
             f"{rec['lk_track']} lk_track launches for {tracks} klt.track calls")
    _require(slam.window.R.is_cuda and slam.window.lmk.is_cuda and slam.obs.uv.is_cuda,
             "window state left the card")
    return rec


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
    if measure:
        phase_clocks(frames, device)
        phase_measure(world, frames, device)
    if "--parent" in sys.argv[1:]:
        phase_parent(sys.argv[sys.argv.index("--parent") + 1], frames[0], device)
    print("library_ms: null for both kernels -- no single PyTorch call computes an LK "
          "iteration loop or a pyramidal forward-backward track")
    print(card)
    lvl0, tr = it_rows[0], tr_rows[0]
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
        "max_abs_err": max(max(r["max_abs_err_uv"], r["max_abs_err_err"]) for r in tr_rows),
        "ms": tr["ms"], "profiler_ms": tr["profiler_ms"], "host_us": tr["host_us"],
        "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
