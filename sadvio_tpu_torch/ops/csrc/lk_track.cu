// Pyramidal forward-backward Lucas-Kanade track of all features in ONE
// launch, written for Hopper (sm_90a), bound to Python through a plain C
// interface.
//
// Replaces, on the card, the whole of sadvio_tpu/frontend/klt.py::track with
// engine="pallas": the per-level template building (_templates), the TPU
// kernel sadvio_tpu/ops/klt_kernel.py::_lk_kernel once per level, the
// backward pass and the forward-backward gate.  Per feature:
//   1. sanitize the affine template warp (identity unless finite and
//      0.25 < det < 4) and form its inverse;
//   2. forward, level levels-1 .. 0: sample the (S+2)^2 halo patch of the
//      source level at uv0 / 2^lvl + warp * offset (bilinear, taps clamped
//      inside the WS x WS template window around the feature), take T and its
//      central-difference gradients, the 2x2 normal matrix and the
//      min-eigenvalue test; run the LK loop on the target level; test that
//      the answer is `radius` inside the level; double (u, v);
//   3. backward on bwd_levels levels: template from the target pyramid at the
//      forward answer with the inverse warp, LK on the source pyramid from
//      uv0;
//   4. valid = valid0 & every level ok & |back - uv0| < fb_thresh
//      & err < max_err.
//
// What bounds it on the card.  By the roofline it is bytes: both pyramids
// read once (3.84 MB at 752 x 480 with 4 levels) against ~50 MFLOP at the
// iteration cap, about a microsecond of memory time.  In practice neither
// bytes nor FLOPs but a dependent chain: up to 6+6+6+10+6 iterations follow
// each other per feature, each one bilinear sampling, a warp reduction and a
// 2x2 solve that says where the next one reads, and between levels a template
// must be gathered before the first iteration can start.  512 features are
// under four warps per SM, so nothing hides latency, neither of memory nor of
// the instruction pipeline: the kernel's time is the length of one warp's
// instruction stream plus the round trips to L2 it waits for.  The cycle
// counters of the -DLK_CLOCKS build (chip_smoke.py --measure prints them)
// show where that stream goes: template building, window fills and the
// iteration loops.
//
// Design.
//  - One launch instead of five kernel launches and ~550 small tensor-op
//    kernels per track; the pyramids' level pointers travel by value in the
//    kernel's parameters, so no table is built on the device per call.
//  - T, gx, gy and the normal matrix never reach device memory: the halo
//    patch goes to shared memory and each lane keeps its ceil(S^2 / 32)
//    template pixels and gradients in registers (lk::Template).
//  - The iteration loop is lk::lk_level (lk_common.cuh, shared with the
//    single-level kernel lk_iterate.cu): the target window is loaded once per
//    level into shared memory by cp.async, so an iteration's dependent loads
//    are shared-memory loads, and the fill is in flight while the level's
//    template is gathered and reduced; a patch that leaves the window
//    reloads it, so the answer does not depend on the margin.  bx and by
//    share one butterfly.
//  - A shorter chain of code: the patch side is a template parameter
//    (no predicates, runtime divisions or unrolled bodies for the largest
//    patch), the forward and backward passes run the same code in one loop
//    instead of two inlined copies, and the window fill is one shared
//    function that addresses by column.
//  - Occupancy: one warp per feature, four warps per block, so 512 features
//    are 128 blocks, one per SM with one warp on each of the SM's four
//    schedulers.  Splitting a patch over several warps would need a
//    shared-memory reduction and a block barrier in every iteration, a longer
//    chain than the one shuffle butterfly it replaces; several blocks per SM
//    change nothing while there are fewer warps than schedulers.  A warp's
//    window and halo patch take (S+1+2m)^2 + (S+2)^2 floats of shared memory
//    (2.3 KB at S = 11, m = 4), far under 48 KB a block.
//  - No TMA: a box load zero-fills outside the image, and the semantics are
//    edge-clamped taps.

#include <cuda_runtime.h>

#include <cstdint>

#include "lk_common.cuh"

namespace {

constexpr int kMaxLevels = 8;

struct Pyramids {
  const float* src[kMaxLevels];  // pyramid the features were detected in
  const float* dst[kMaxLevels];  // pyramid they are tracked into
  int H[kMaxLevels];
  int W[kMaxLevels];
};

struct Params {
  int N, levels, bwd_levels, iters, iters_coarse, margin;
  float min_eig, fb_thresh, max_err, eps2;
};

#ifdef LK_CLOCKS
// Per feature: cycles in template building, in window loads, in the level
// loops without their loads, in the whole kernel; window loads; iterations.
constexpr int kClockFields = 6;
constexpr int kClockFeatures = 4096;
__device__ long long g_clocks[kClockFeatures * kClockFields];
#endif

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.0f; }

// Template of one feature on one level, as ops/klt_kernel.py::templates forms
// it: halo patch around (ax, ay) warped by [w00 w01; w10 w11], sampled inside
// the feature's template window.  Returns the min-eigenvalue verdict.
template <int S>
__device__ __forceinline__ bool build_template(const float* __restrict__ img, int H, int W,
                                               int lane, const lk::Lanes<S>& L, float* halo,
                                               float ax, float ay, float w00, float w01,
                                               float w10, float w11, float min_eig,
                                               lk::Template<S>& tp) {
  constexpr int rh = (S - 1) / 2 + 1;
  constexpr int Sh = S + 2;
  constexpr int kHaloPerLane = (Sh * Sh + 31) / 32;
  const int WS = min(min(2 * (2 * rh + 2) + 2, H), W);
  // corner of the template window: floor(uv) - WS / 2, kept inside the image
  const float bx = fminf(fmaxf(floorf(finite_or_zero(ax)) - (WS / 2), 0.0f),
                         static_cast<float>(W - WS));
  const float by = fminf(fmaxf(floorf(finite_or_zero(ay)) - (WS / 2), 0.0f),
                         static_cast<float>(H - WS));
  const float* __restrict__ win = img + static_cast<int>(by) * W + static_cast<int>(bx);
  const float top = static_cast<float>(WS - 2);

  __syncwarp();  // every lane is done with the previous level's halo patch
  // fully unrolled over the lane's halo pixels, so all of a lane's taps are
  // in flight together
#pragma unroll
  for (int k = 0; k < kHaloPerLane; ++k) {
    const int q = lane + 32 * k;
    if (q < Sh * Sh) {
      const int hy = q / Sh, hx = q - hy * Sh;
      const float dx = static_cast<float>(hx - rh), dy = static_cast<float>(hy - rh);
      const float lx = ax + (dx * w00 + dy * w01) - bx;
      const float ly = ay + (dx * w10 + dy * w11) - by;
      const float flx = floorf(lx), fly = floorf(ly);
      const float fx = lx - flx, fy = ly - fly;
      // fmaxf(NaN, 0) is 0: a NaN coordinate reads tap 0 and the weights stay NaN
      const int ix = static_cast<int>(fminf(fmaxf(flx, 0.0f), top));
      const int iy = static_cast<int>(fminf(fmaxf(fly, 0.0f), top));
      const float* __restrict__ p = win + iy * W + ix;
      const float p00 = __ldg(p), p01 = __ldg(p + 1), p10 = __ldg(p + W), p11 = __ldg(p + W + 1);
      halo[q] = p00 * (1.0f - fx) * (1.0f - fy) + p01 * fx * (1.0f - fy)
              + p10 * (1.0f - fx) * fy + p11 * fx * fy;
    }
  }
  __syncwarp();

  float a = 0.0f, b = 0.0f, c = 0.0f;
#pragma unroll
  for (int k = 0; k < lk::Lanes<S>::kPerLane; ++k) {
    const int i = (L.row[k] + 1) * Sh + L.col[k] + 1;
    const float gx = 0.5f * (halo[i + 1] - halo[i - 1]);
    const float gy = 0.5f * (halo[i + Sh] - halo[i - Sh]);
    tp.t[k] = L.in[k] ? halo[i] : 0.0f;
    tp.gx[k] = L.in[k] ? gx : 0.0f;
    tp.gy[k] = L.in[k] ? gy : 0.0f;
    a += tp.gx[k] * tp.gx[k];
    b += tp.gx[k] * tp.gy[k];
    c += tp.gy[k] * tp.gy[k];
  }
  lk::warp_sum3(a, b, c);
  const float det = a * c - b * b;
  const float tr = a + c;
  const float eig_min = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
  tp.a = a;
  tp.b = b;
  tp.c = c;
  tp.inv_det = fabsf(det) < 1e-9f ? 0.0f : 1.0f / det;
  return eig_min / static_cast<float>(S * S) > min_eig;
}

template <int S>
__global__ void __launch_bounds__(lk::kWarpsPerBlock * 32)
lk_track_kernel(const __grid_constant__ Pyramids pyr, const __grid_constant__ Params P,
                const float* __restrict__ uv0, const float* __restrict__ uv_init,
                const uint8_t* __restrict__ valid0, const float* __restrict__ warp,
                float* __restrict__ uv1, uint8_t* __restrict__ valid, float* __restrict__ err_out,
                int per_warp) {
  extern __shared__ float smem[];
  LK_CLOCKS_ONLY(const long long t_start = clock64(); long long clk[kClockFields] = {};)
  constexpr int radius = (S - 1) / 2;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int f = blockIdx.x * lk::kWarpsPerBlock + wid;
  if (f >= P.N) return;  // uniform within the warp
  const lk::Lanes<S> L(lane);
  lk::Template<S> tp;
  lk::Window win;
  win.side = lk::window_side(S, P.margin);
  win.margin = P.margin;
  win.data = smem + wid * per_warp;
  float* halo = win.data + win.side * win.side;

  // template warp (identity when absent, singular, out of range or not
  // finite); the backward pass takes its inverse
  float w00 = 1.0f, w01 = 0.0f, w10 = 0.0f, w11 = 1.0f, det = 1.0f;
  if (warp != nullptr) {
    const float a00 = warp[4 * f + 0], a01 = warp[4 * f + 1];
    const float a10 = warp[4 * f + 2], a11 = warp[4 * f + 3];
    const float d = a00 * a11 - a01 * a10;
    if (d > 0.25f && d < 4.0f && isfinite(a00) && isfinite(a01) && isfinite(a10)
        && isfinite(a11)) {
      w00 = a00, w01 = a01, w10 = a10, w11 = a11, det = d;
    }
  }

  const float x0 = uv0[2 * f + 0], y0 = uv0[2 * f + 1];
  // pass 0, forward: templates from `src` anchored at uv0, LK on `dst` from
  // uv_init.  pass 1, backward: templates from `dst` anchored at the forward
  // answer, LK on `src` from uv0.  One copy of the code serves both.
  float ax = x0, ay = y0;  // template anchor, level-0 pixels
  float u = uv_init[2 * f + 0], v = uv_init[2 * f + 1];
  float u_fwd = 0.0f, v_fwd = 0.0f, err_fwd = 0.0f;
  bool ok_all = true;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const bool bwd = pass == 1;
    const float* const* pa = bwd ? pyr.dst : pyr.src;
    const float* const* pb = bwd ? pyr.src : pyr.dst;
    const int use_levels = bwd ? P.bwd_levels : P.levels;
    const float top = 1.0f / static_cast<float>(1 << (use_levels - 1));
    u *= top;
    v *= top;
    float err = 0.0f;
#pragma unroll 1
    for (int lvl = use_levels - 1; lvl >= 0; --lvl) {
      const int H = pyr.H[lvl], W = pyr.W[lvl];
      const float s = 1.0f / static_cast<float>(1 << lvl);
      // the target window's fill is in flight while the template is built
      win.prefetch_at(pb[lvl], H, W, S, u, v, lane);
      LK_CLOCKS_ONLY(const long long t0 = clock64();)
      const bool good = build_template<S>(pa[lvl], H, W, lane, L, halo, ax * s, ay * s, w00,
                                          w01, w10, w11, P.min_eig, tp);
      LK_CLOCKS_ONLY(const long long t1 = clock64();)
      err = lk::lk_level<S>(pb[lvl], H, W, lane, L, tp, win,
                            (lvl == 0 && !bwd) ? P.iters : P.iters_coarse, P.eps2, u, v);
      LK_CLOCKS_ONLY(clk[0] += t1 - t0; clk[2] += clock64() - t1;)
      const bool inb = u >= radius && u < W - radius && v >= radius && v < H - radius;
      ok_all = ok_all && good && inb;
      if (lvl > 0) {
        u *= 2.0f;
        v *= 2.0f;
      }
    }
    if (!bwd) {
      u_fwd = u, v_fwd = v, err_fwd = err;
      ax = u, ay = v;
      u = x0, v = y0;
      const float i00 = w11 / det, i01 = -w01 / det, i10 = -w10 / det, i11 = w00 / det;
      w00 = i00, w01 = i01, w10 = i10, w11 = i11;
    }
  }
  if (lane == 0) {
    const float dx = u - x0, dy = v - y0;
    const float fb = sqrtf(dx * dx + dy * dy);
    uv1[2 * f + 0] = u_fwd;
    uv1[2 * f + 1] = v_fwd;
    err_out[f] = err_fwd;
    valid[f] = valid0[f] != 0 && ok_all && fb < P.fb_thresh && err_fwd < P.max_err;
#ifdef LK_CLOCKS
    clk[1] = win.load_cycles, clk[2] -= win.inner_cycles, clk[4] = win.loads;
    clk[5] = win.iterations, clk[3] = clock64() - t_start;
    if (f < kClockFeatures) {
      for (int k = 0; k < kClockFields; ++k) g_clocks[f * kClockFields + k] = clk[k];
    }
#endif
  }
}

template <int S>
int launch(const Pyramids& pyr, const Params& P, const float* uv0, const float* uv_init,
           const uint8_t* valid0, const float* warp, float* uv1, uint8_t* valid, float* err,
           cudaStream_t stream) {
  const int side = lk::window_side(S, P.margin);
  const int per_warp = side * side + (S + 2) * (S + 2);  // target window, halo patch
  const size_t smem = sizeof(float) * lk::kWarpsPerBlock * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_track_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(lk::kWarpsPerBlock * 32);
  const dim3 grid((P.N + lk::kWarpsPerBlock - 1) / lk::kWarpsPerBlock);
  lk_track_kernel<S><<<grid, block, smem, stream>>>(pyr, P, uv0, uv_init, valid0, warp, uv1,
                                                    valid, err, per_warp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// pyr0, pyr1, Hs, Ws are HOST arrays of `levels` entries: device pointers to
// the contiguous float32 levels of the source and target pyramids and their
// dims.  The rest are device pointers to contiguous arrays: uv0, uv_init
// (N,2) float32; valid0 (N,) bytes; warp (N,2,2) float32 or null for the
// identity; out: uv1 (N,2) float32, valid (N,) bytes, err (N,) float32.
extern "C" int lk_track_launch(const float* const* pyr0, const float* const* pyr1, const int* Hs,
                               const int* Ws, const float* uv0, const float* uv_init,
                               const uint8_t* valid0, const float* warp, float* uv1,
                               uint8_t* valid, float* err, int N, int S, int levels,
                               int bwd_levels, int iters, int iters_coarse, int margin,
                               float min_eig, float fb_thresh, float max_err, float eps2,
                               void* stream) {
  if (N <= 0) return 0;
  if (levels < 1 || levels > kMaxLevels || bwd_levels < 1 || bwd_levels > levels || margin < 0
      || iters < 0 || iters_coarse < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramids pyr{};
  for (int l = 0; l < levels; ++l) {
    if (Hs[l] < 2 || Ws[l] < 2) return static_cast<int>(cudaErrorInvalidValue);
    pyr.src[l] = pyr0[l];
    pyr.dst[l] = pyr1[l];
    pyr.H[l] = Hs[l];
    pyr.W[l] = Ws[l];
  }
  const Params P{N, levels, bwd_levels, iters, iters_coarse, margin,
                 min_eig, fb_thresh, max_err, eps2};
  LK_RETURN_FOR_PATCH_SIDE(S, launch, pyr, P, uv0, uv_init, valid0, warp, uv1, valid, err,
                           static_cast<cudaStream_t>(stream))
}

#ifdef LK_CLOCKS
// Copies the last launch's per-feature counters, (n, 6) int64 on the host:
// [template cycles, window-load cycles, level-loop cycles without loads,
// kernel cycles, window loads, iterations].  Synchronises the device.
extern "C" int lk_track_clocks(long long* out, int n) {
  if (n < 0 || n > kClockFeatures) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * n * kClockFields));
}
#endif
