// Device code shared by the two LK kernels (lk_iterate.cu, lk_track.cu): the
// per-lane patch layout, the warp reductions and the inverse-compositional
// iteration loop on one pyramid level.  One warp owns one feature.
//
// The loop reads its bilinear taps from a window of the target image held in
// shared memory, so the dependent loads of an iteration are shared-memory
// loads and not L2 round trips.  The window is (S + 1 + 2 m)^2 floats around
// the patch corner it was loaded for, filled by cp.async from edge-clamped
// image coordinates, so a tap read from it has the value an edge-clamped
// read of the image would have.  When the patch leaves the window the warp
// reloads it around the new corner (u and v are bit-identical in every lane,
// so the decision is warp-uniform): the result does not depend on the
// margin m.

#pragma once

#include <cuda_runtime.h>

namespace lk {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxS = 15;
constexpr int kMargin = 4;  // default window margin m, pixels each side

__host__ __device__ __forceinline__ int window_side(int S, int margin) {
  return S + 1 + 2 * margin;
}

// xor butterflies: every lane ends with the bit-identical sum, which keeps
// the convergence test uniform across the warp.  The two- and three-value
// forms interleave their shuffles, so an iteration waits on one chain.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ void warp_sum2(float& x, float& y) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ox = __shfl_xor_sync(0xffffffffu, x, m);
    const float oy = __shfl_xor_sync(0xffffffffu, y, m);
    x += ox;
    y += oy;
  }
}

__device__ __forceinline__ void warp_sum3(float& x, float& y, float& z) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ox = __shfl_xor_sync(0xffffffffu, x, m);
    const float oy = __shfl_xor_sync(0xffffffffu, y, m);
    const float oz = __shfl_xor_sync(0xffffffffu, z, m);
    x += ox;
    y += oy;
    z += oz;
  }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Integer patch corner from a floored coordinate; NaN maps to 0 (the
// fractional part is NaN then, so the patch is NaN whatever the corner).
__device__ __forceinline__ int corner(float fl, int extent) {
  return isnan(fl) ? 0 : static_cast<int>(fminf(fmaxf(fl, -1.0f), static_cast<float>(extent)));
}

// The patch side S is a template parameter: with one warp on each of an
// SM's schedulers nothing hides pipeline latency, so what the kernels
// cost is the length of the code they execute, and a compile-time S drops the
// predicates, the runtime divisions and half of the unrolled bodies that a
// runtime S <= kMaxS needs.
//
// A lane's share of the S x S patch: pixel p = lane + 32 k for k < kPerLane.
template <int S>
struct Lanes {
  static constexpr int kPerLane = (S * S + 31) / 32;
  bool in[kPerLane];  // p < S^2
  int row[kPerLane];
  int col[kPerLane];

  __device__ __forceinline__ explicit Lanes(int lane) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int p = lane + 32 * k;
      in[k] = p < S * S;
      const int q = in[k] ? p : 0;
      row[k] = q / S;
      col[k] = q - row[k] * S;
    }
  }
};

// The template a warp iterates against, spread over its lanes' registers.
template <int S>
struct Template {
  float t[Lanes<S>::kPerLane], gx[Lanes<S>::kPerLane], gy[Lanes<S>::kPerLane];
  float a, b, c, inv_det;  // 2x2 normal matrix [a b; b c] and 1 / det
};

// Built with -DLK_CLOCKS the kernels count cycles per phase (clock64) and
// iterations per feature; see lk_track.cu.  Off by default: no code is added.
#ifdef LK_CLOCKS
#define LK_CLOCKS_ONLY(...) __VA_ARGS__
#else
#define LK_CLOCKS_ONLY(...)
#endif

// Starts filling a window of side * side floats whose corner is image pixel
// (x0, y0) from edge-clamped image coordinates, one 4-byte cp.async per
// element: every copy is in flight at once and none passes through a
// register, so a fill costs one round trip to L2 and whatever the caller
// does before it waits overlaps with it.  Not inlined: one copy serves every
// level.
static __device__ __noinline__ void fill_window_async(float* data, int side, int x0, int y0,
                                                      const float* __restrict__ img, int H,
                                                      int W, int lane) {
  __syncwarp();  // every lane is done with the old contents
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(data));
  // a lane copies one column, row after row: a warp-wide copy is one row
  for (int c = lane; c < side; c += 32) {
    const float* col = img + clampi(x0 + c, 0, W - 1);
#pragma unroll 4
    for (int r = 0; r < side; ++r) {
      const float* src = col + clampi(y0 + r, 0, H - 1) * W;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4u * (r * side + c)),
                   "l"(src)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Integer corner of the S x S patch centred at coordinate x, and the
// fractional offset every pixel of the patch shares.
__device__ __forceinline__ int patch_corner(float x, int half, int extent, float& frac) {
  const float l = x - half;
  const float fl = floorf(l);
  frac = l - fl;
  return corner(fl, extent);
}

// The target window of one warp in shared memory.
struct Window {
  float* data;  // side * side floats
  int side;
  int margin;
  int x0, y0;  // image coordinates of data[0]
  LK_CLOCKS_ONLY(long long load_cycles = 0; long long inner_cycles = 0; int loads = 0;
                 int iterations = 0;)

  __device__ __forceinline__ bool holds(int ix, int iy, int S) const {
    const int ox = ix - x0, oy = iy - y0;
    return ox >= 0 && oy >= 0 && ox + S < side && oy + S < side;
  }

  // Start the fill around patch corner (ix, iy); wait() before reading.
  __device__ __forceinline__ void prefetch(const float* __restrict__ img, int H, int W, int ix,
                                           int iy, int lane) {
    LK_CLOCKS_ONLY(const long long t0 = clock64();)
    x0 = ix - margin;
    y0 = iy - margin;
    fill_window_async(data, side, x0, y0, img, H, W, lane);
    LK_CLOCKS_ONLY(load_cycles += clock64() - t0; ++loads;)
  }

  // Start the fill for the patch of side S centred at (u, v).
  __device__ __forceinline__ void prefetch_at(const float* __restrict__ img, int H, int W, int S,
                                              float u, float v, int lane) {
    float frac;
    const int ix = patch_corner(u, (S - 1) / 2, W, frac);
    const int iy = patch_corner(v, (S - 1) / 2, H, frac);
    prefetch(img, H, W, ix, iy, lane);
  }

  // Every copy of the last fill has landed and is visible to the warp.
  __device__ __forceinline__ void wait() {
    LK_CLOCKS_ONLY(const long long t0 = clock64();)
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    LK_CLOCKS_ONLY(load_cycles += clock64() - t0;)
  }
};

// Inverse-compositional LK on one level for one feature: iterate (u, v) from
// its start until the step is at most eps (eps2 = eps^2), `iters` is reached
// or the step is NaN; returns the mean |patch - T| at the last position.
// The patch corner is floor((u, v) - half) and every pixel of the patch
// shares the fractional offset.  The caller has started the window's fill
// for this image (Window::prefetch_at at the start position).
template <int S>
__device__ __forceinline__ float lk_level(const float* __restrict__ img, int H, int W, int lane,
                                          const Lanes<S>& L, const Template<S>& tp, Window& win,
                                          int iters, float eps2, float& u, float& v) {
  constexpr int K = Lanes<S>::kPerLane;
  constexpr int half = (S - 1) / 2;
  LK_CLOCKS_ONLY(const long long loads_before = win.load_cycles;)
  win.wait();
  int off[K];  // window offset of this lane's pixels from the patch corner
#pragma unroll
  for (int k = 0; k < K; ++k) off[k] = L.row[k] * win.side + L.col[k];

  float fx, fy;
  // window index of the patch corner at (u, v); reloads the window if needed
  auto locate = [&]() -> int {
    const int ix = patch_corner(u, half, W, fx), iy = patch_corner(v, half, H, fy);
    if (!win.holds(ix, iy, S)) {
      win.prefetch(img, H, W, ix, iy, lane);
      win.wait();
    }
    return (iy - win.y0) * win.side + (ix - win.x0);
  };
  auto sample = [&](int i) -> float {
    const float p00 = win.data[i], p01 = win.data[i + 1];
    const float p10 = win.data[i + win.side], p11 = win.data[i + win.side + 1];
    return p00 * (1.0f - fx) * (1.0f - fy) + p01 * fx * (1.0f - fy)
         + p10 * (1.0f - fx) * fy + p11 * fx * fy;
  };

  float step2 = INFINITY;
#pragma unroll 1
  for (int it = 0; it < iters && step2 > eps2; ++it) {
    const int base = locate();
    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (L.in[k]) {
        const float e = sample(base + off[k]) - tp.t[k];
        bx += e * tp.gx[k];
        by += e * tp.gy[k];
      }
    }
    warp_sum2(bx, by);
    const float du = (tp.c * bx - tp.b * by) * tp.inv_det;
    const float dv = (tp.a * by - tp.b * bx) * tp.inv_det;
    u -= du;
    v -= dv;
    step2 = du * du + dv * dv;  // NaN compares false and ends the loop
    LK_CLOCKS_ONLY(++win.iterations;)
  }

  const int base = locate();
  float es = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (L.in[k]) es += fabsf(sample(base + off[k]) - tp.t[k]);
  }
  LK_CLOCKS_ONLY(win.inner_cycles += win.load_cycles - loads_before;)
  return warp_sum(es) / static_cast<float>(S * S);
}

}  // namespace lk

// `return FN<S>(args...)` with the patch side as a compile-time constant, or
// cudaErrorInvalidValue if S is not an odd side up to kMaxS.
#define LK_RETURN_FOR_PATCH_SIDE(S, FN, ...)                  \
  switch (S) {                                                \
    case 1: return FN<1>(__VA_ARGS__);                        \
    case 3: return FN<3>(__VA_ARGS__);                        \
    case 5: return FN<5>(__VA_ARGS__);                        \
    case 7: return FN<7>(__VA_ARGS__);                        \
    case 9: return FN<9>(__VA_ARGS__);                        \
    case 11: return FN<11>(__VA_ARGS__);                      \
    case 13: return FN<13>(__VA_ARGS__);                      \
    case 15: return FN<15>(__VA_ARGS__);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }
