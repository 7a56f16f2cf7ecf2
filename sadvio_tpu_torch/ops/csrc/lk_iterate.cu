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
// What bounds it on the card: the latency of a dependent chain, not FLOPs or
// bytes.  An iteration reads 4 S^2 texels and does ~10 S^2 FLOPs, then every
// lane waits on a warp reduction before it knows where the next iteration
// reads; the whole level image (at most 752 x 480 x 4 B, 1.4 MB) stays in L2.
//
// Design: one warp per feature, four warps per block.  Each lane keeps its
// share of the template and its gradients (ceil(S^2 / 32) pixels) in
// registers for the whole loop.  The loop itself is lk::lk_level of
// lk_common.cuh, shared with the fused track kernel (lk_track.cu): the
// target window sits in shared memory, filled once by cp.async from
// edge-clamped image coordinates (the same values as edge-replicated padding)
// while the template is read into registers, the two sums of
// an iteration are reduced in one interleaved __shfl_xor_sync butterfly that
// leaves the bit-identical sum in every lane, so the convergence test is
// uniform across the warp and each warp leaves its loop on its own -- no
// lock-step across features.  The TPU kernel's structure (8 features per
// program, a DMA'd 40 x 256 VMEM window and lane-roll addressing) has no
// counterpart here.

#include <cuda_runtime.h>

#include "lk_common.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(lk::kWarpsPerBlock * 32)
lk_iterate_kernel(const float* __restrict__ img, const float* __restrict__ uv_init,
                  const float* __restrict__ T, const float* __restrict__ gx,
                  const float* __restrict__ gy, const float* __restrict__ nrm,
                  float* __restrict__ out, int N, int H, int W, int iters, float eps2) {
  extern __shared__ float smem[];
  constexpr int SS = S * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * lk::kWarpsPerBlock + warp;
  if (f >= N) return;  // uniform within the warp

  float u = uv_init[2 * f + 0];
  float v = uv_init[2 * f + 1];
  lk::Window win;
  win.side = lk::window_side(S, lk::kMargin);
  win.margin = lk::kMargin;
  win.data = smem + warp * win.side * win.side;
  win.prefetch_at(img, H, W, S, u, v, lane);  // lands while the template is read

  const lk::Lanes<S> L(lane);
  lk::Template<S> tp;
#pragma unroll
  for (int k = 0; k < lk::Lanes<S>::kPerLane; ++k) {
    const size_t o = static_cast<size_t>(f) * SS + L.row[k] * S + L.col[k];
    tp.t[k] = L.in[k] ? T[o] : 0.0f;
    tp.gx[k] = L.in[k] ? gx[o] : 0.0f;
    tp.gy[k] = L.in[k] ? gy[o] : 0.0f;
  }
  tp.a = nrm[4 * f + 0];
  tp.b = nrm[4 * f + 1];
  tp.c = nrm[4 * f + 2];
  tp.inv_det = nrm[4 * f + 3];
  const float err = lk::lk_level<S>(img, H, W, lane, L, tp, win, iters, eps2, u, v);
  if (lane == 0) {
    out[3 * f + 0] = u;
    out[3 * f + 1] = v;
    out[3 * f + 2] = err;
  }
}

template <int S>
int launch(const float* img, const float* uv_init, const float* T, const float* gx,
           const float* gy, const float* nrm, float* out, int N, int H, int W, int iters,
           float eps2, cudaStream_t stream) {
  const int side = lk::window_side(S, lk::kMargin);
  const size_t smem = sizeof(float) * lk::kWarpsPerBlock * side * side;  // 9 KB at S = 15
  const dim3 block(lk::kWarpsPerBlock * 32);
  const dim3 grid((N + lk::kWarpsPerBlock - 1) / lk::kWarpsPerBlock);
  lk_iterate_kernel<S><<<grid, block, smem, stream>>>(img, uv_init, T, gx, gy, nrm, out, N, H, W,
                                                      iters, eps2);
  return static_cast<int>(cudaGetLastError());
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
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  LK_RETURN_FOR_PATCH_SIDE(S, launch, img, uv_init, T, gx, gy, nrm, out, N, H, W, iters, eps2,
                           static_cast<cudaStream_t>(stream))
}
