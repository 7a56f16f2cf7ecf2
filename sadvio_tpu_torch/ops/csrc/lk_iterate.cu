// Inverse-compositional Lucas-Kanade iteration loop on one pyramid level,
// written for Hopper (sm_90a), bound to Python through a plain C interface.
//
// Replaces the TPU kernel sadvio_tpu/ops/klt_kernel.py::_lk_kernel
// (launched by lk_iterate).  Per feature: sample an S x S bilinear patch of
// the target image at (u, v) -- every pixel of the patch shares one
// fractional offset -- take e = patch - T, bx = sum(e gx), by = sum(e gy),
// solve the closed-form 2x2 step from nrm = [a, b, c, inv_det] and update
// (u, v); stop when the step drops to eps or at `iters`, or at once when the
// step is NaN.  Output per feature: [u, v, mean |patch - T|] at the last
// position.
//
// What bounds it on the card: latency of dependent image gathers, not
// FLOPs or bytes.  An iteration reads 4 S^2 texels and does ~10 S^2 FLOPs,
// then every lane waits on a warp reduction before the next iteration may
// start; the whole level image (at most 752 x 480 x 4 B, 1.4 MB) stays in L2.
//
// Design: one warp per feature, four warps per block.  Each lane keeps its
// share of the template and its gradients (ceil(S^2 / 32) pixels) in
// registers for the whole loop, reads its taps straight from the image
// through the read-only cache with edge-clamped integer coordinates (the
// same values as edge-replicated padding), and the two sums and the final
// error are reduced with __shfl_xor_sync.  The xor butterfly leaves the
// bit-identical sum in every lane, so the convergence test is uniform across
// the warp and each warp leaves its loop on its own -- no lock-step across
// features.  The TPU kernel's structure (8 features per program, a DMA'd
// 40 x 256 VMEM window and lane-roll addressing) has no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxS = 15;
constexpr int kPerLane = (kMaxS * kMaxS + 31) / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Integer patch corner from a floored coordinate; NaN maps to 0 (the
// fractional part is NaN then, so the patch is NaN whatever the corner).
__device__ __forceinline__ int corner(float fl, int extent) {
  return isnan(fl) ? 0 : static_cast<int>(fminf(fmaxf(fl, -1.0f), static_cast<float>(extent)));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_iterate_kernel(const float* __restrict__ img, const float* __restrict__ uv_init,
                  const float* __restrict__ T, const float* __restrict__ gx,
                  const float* __restrict__ gy, const float* __restrict__ nrm,
                  float* __restrict__ out, int N, int S, int H, int W, int iters,
                  float eps2) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= N) return;  // uniform within the warp
  const int SS = S * S;
  const int half = (S - 1) / 2;

  float t[kPerLane], tx[kPerLane], ty[kPerLane];
  int pr[kPerLane], pc[kPerLane];
  bool in[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int p = lane + 32 * k;
    in[k] = p < SS;
    const int q = in[k] ? p : 0;
    pr[k] = q / S;
    pc[k] = q - pr[k] * S;
    const size_t o = static_cast<size_t>(f) * SS + q;
    t[k] = in[k] ? T[o] : 0.0f;
    tx[k] = in[k] ? gx[o] : 0.0f;
    ty[k] = in[k] ? gy[o] : 0.0f;
  }
  const float a = nrm[4 * f + 0];
  const float b = nrm[4 * f + 1];
  const float c = nrm[4 * f + 2];
  const float inv_det = nrm[4 * f + 3];
  float u = uv_init[2 * f + 0];
  float v = uv_init[2 * f + 1];

  // bilinear patch value of this lane's pixel k at patch centre (u, v)
  auto sample = [&](int k, int ix, int iy, float fx, float fy) -> float {
    const int r0 = clampi(iy + pr[k], 0, H - 1);
    const int r1 = clampi(iy + pr[k] + 1, 0, H - 1);
    const int c0 = clampi(ix + pc[k], 0, W - 1);
    const int c1 = clampi(ix + pc[k] + 1, 0, W - 1);
    const float p00 = __ldg(img + r0 * W + c0);
    const float p01 = __ldg(img + r0 * W + c1);
    const float p10 = __ldg(img + r1 * W + c0);
    const float p11 = __ldg(img + r1 * W + c1);
    return p00 * (1.0f - fx) * (1.0f - fy) + p01 * fx * (1.0f - fy)
         + p10 * (1.0f - fx) * fy + p11 * fx * fy;
  };

  float step2 = INFINITY;
  for (int it = 0; it < iters && step2 > eps2; ++it) {
    const float lx = u - half, ly = v - half;
    const float flx = floorf(lx), fly = floorf(ly);
    const float fx = lx - flx, fy = ly - fly;
    const int ix = corner(flx, W), iy = corner(fly, H);
    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (in[k]) {
        const float e = sample(k, ix, iy, fx, fy) - t[k];
        bx += e * tx[k];
        by += e * ty[k];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float du = (c * bx - b * by) * inv_det;
    const float dv = (a * by - b * bx) * inv_det;
    u -= du;
    v -= dv;
    step2 = du * du + dv * dv;  // NaN compares false and ends the loop
  }

  const float lx = u - half, ly = v - half;
  const float flx = floorf(lx), fly = floorf(ly);
  const float fx = lx - flx, fy = ly - fly;
  const int ix = corner(flx, W), iy = corner(fly, H);
  float es = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (in[k]) es += fabsf(sample(k, ix, iy, fx, fy) - t[k]);
  }
  es = warp_sum(es);
  if (lane == 0) {
    out[3 * f + 0] = u;
    out[3 * f + 1] = v;
    out[3 * f + 2] = es / static_cast<float>(SS);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous float32 arrays:
// img (H,W), uv_init (N,2), T/gx/gy (N,S,S), nrm (N,4), out (N,3).
extern "C" int lk_iterate_launch(const float* img, const float* uv_init, const float* T,
                                 const float* gx, const float* gy, const float* nrm,
                                 float* out, int N, int S, int H, int W, int iters,
                                 float eps2, void* stream) {
  if (N <= 0) return 0;
  if (S < 1 || S > kMaxS || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lk_iterate_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, uv_init, T, gx, gy, nrm, out, N, S, H, W, iters, eps2);
  return static_cast<int>(cudaGetLastError());
}
