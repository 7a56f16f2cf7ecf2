// On-manifold IMU preintegration of one buffer of samples in one launch
// (models/imu.py preintegrate), written for Hopper (sm_90a), bound to Python
// through a plain C interface.
//
// Replaces no TPU kernel: the JAX package runs this recursion as a masked
// lax.scan that XLA compiles.  The port ran it as a Python loop of ~80 small
// torch ops a sample; captured into the pipeline's _preint graph that loop was
// 2,614 graph nodes for one 32-row batch of ~10 samples (PERF.md section 5),
// 3.6 ms of device time at the card's ~1.4 us for each dependent node.
//
// What bounds it on the card: the dependency chain of the samples, not bytes
// or operations.  A 32-row batch is under 1 KB of input and ~40 kFLOP, but
// each sample's update (the 9x9 covariance A cov A^T + (B q) B^T, the five
// 3x3 bias Jacobians, dR, dv, dp) needs the state the sample before it left.
//
// Design: one block per call, the whole state in shared memory for the length
// of the buffer.  The terms that do not depend on the running state (the
// bias-corrected rates, Exp(w dt) and its right Jacobian, the noise weights q)
// are computed first for a tile of up to kThreads samples, one sample per
// thread, with the small-angle branches and threshold of utils/geometry.py
// (_theta_split, so3_exp, so3_left_jacobian).  The block then steps through
// the tile's samples in three phases a sample, separated by __syncthreads:
// (1) one thread per entry of the transitions A (9x9) and B (9x6) and of the
// new dR, dv, dp, bias Jacobians and dt; (2) one thread per entry of A cov;
// (3) one thread per entry of the new covariance.  So a sample costs three
// barriers and a few shared-memory dot products of length 9, not ~80 launches.
// A padding sample (dt <= 0, or NaN) is skipped by a branch that every thread
// takes alike: an exact no-op, as in the plain version.  The state is double
// buffered, so no phase reads an entry that it writes.  Everything is
// float32; sinf, cosf, sqrtf and the divisions keep full precision (no
// --use_fast_math).  No atomics: the result does not change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one sample a thread in the per-sample terms
constexpr float kEps = 1e-8f;  // utils/geometry.py _EPS: the small-angle threshold on theta^2

// The state, in the layout of the output buffer (models/imu.py _STATE_SHAPES).
constexpr int kDR = 0, kDV = 9, kDP = 12, kCov = 15, kJdRbg = 96, kJdvba = 105, kJdvbg = 114,
              kJdpba = 123, kJdpbg = 132, kDt = 141, kState = 142;
constexpr int kFields = 10;

// The preintegration the buffer continues: one pointer per field in the
// order above.
struct Init {
  const float* p[kFields];
};

// Per-sample terms that do not depend on the running state.
struct Row {
  float h;       // dt, 0 on a padding sample
  float qg, qa;  // gyr_noise^2 / dt, acc_noise^2 / dt
  float ac[3];   // acc - ba
  float dRi[9];  // Exp((gyr - bg) dt), row-major
  float Jr[9];   // its right Jacobian
};

__device__ __forceinline__ float eye(int r, int c) { return r == c ? 1.f : 0.f; }

// skew(v)[r][c]: [[0, -v2, v1], [v2, 0, -v0], [-v1, v0, 0]]
__device__ __forceinline__ float skew_at(const float* v, int r, int c) {
  if (r == c) return 0.f;
  const float x = v[3 - r - c];
  return (c - r + 3) % 3 == 1 ? -x : x;
}

__device__ void row_terms(const float* __restrict__ acc, const float* __restrict__ gyr, float dt,
                          const float* __restrict__ ba, const float* __restrict__ bg, float gn2,
                          float an2, Row& row) {
  const bool active = dt > 0.f;
  const float h = active ? dt : 0.f;
  const float hs = active ? dt : 1.f;
  float w[3];
  for (int k = 0; k < 3; ++k) {
    row.ac[k] = acc[k] - ba[k];
    w[k] = (gyr[k] - bg[k]) * h;
  }
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < kEps;
  const float t2 = small ? 1.f : theta2;
  const float theta = sqrtf(t2);
  const float s = sinf(theta), c = cosf(theta);
  // so3_exp(w) = I + a W + b W^2; the right Jacobian = so3_left_jacobian(-w)
  // = I - ja W + jb W^2 (skew(-w) = -W, and (-W)^2 = W^2)
  const float ea = small ? 1.f - theta2 / 6.f : s / theta;
  const float eb = small ? 0.5f - theta2 / 24.f : (1.f - c) / t2;
  const float ja = small ? 0.5f - theta2 / 24.f : (1.f - c) / t2;
  const float jb = small ? 1.f / 6.f - theta2 / 120.f : (theta - s) / (t2 * theta);
  for (int r = 0; r < 3; ++r) {
    for (int cc = 0; cc < 3; ++cc) {
      float w2 = 0.f;
      for (int k = 0; k < 3; ++k) w2 += skew_at(w, r, k) * skew_at(w, k, cc);
      const float W = skew_at(w, r, cc);
      row.dRi[3 * r + cc] = eye(r, cc) + ea * W + eb * w2;
      row.Jr[3 * r + cc] = eye(r, cc) + ja * -W + jb * w2;
    }
  }
  row.h = h;
  row.qg = (1.f / hs) * gn2;
  row.qa = (1.f / hs) * an2;
}

__device__ float init_value(const Init& init, int e) {
  const int start[kFields + 1] = {kDR, kDV, kDP, kCov, kJdRbg, kJdvba, kJdvbg, kJdpba, kJdpbg,
                                  kDt, kState};
  int f = 0;
  while (e >= start[f + 1]) ++f;
  return init.p[f][e - start[f]];
}

// (dR [skew(a_c)])[r][c], the plain version's Ra
__device__ __forceinline__ float ra(const float* S, const float* ac, int r, int c) {
  float x = 0.f;
  for (int k = 0; k < 3; ++k) x += S[kDR + 3 * r + k] * skew_at(ac, k, c);
  return x;
}

// Phase 1 of a sample: thread t builds A[t] (t < 81), B[t - 81] (t < 135)
// or the (t - 135)-th entry of the new state outside the covariance.
__device__ void transitions_and_deltas(const Row& row, const float* S, float* D, float* A,
                                       float* B, float* Bq, int t) {
  const float h = row.h;
  if (t < 81) {
    const int i = t / 9, j = t % 9, ri = i % 3, cj = j % 3, bi = i / 3, bj = j / 3;
    float v;
    if (bi == 0) {
      v = bj == 0 ? row.dRi[3 * cj + ri] : 0.f;  // dR_inc^T
    } else if (bj == 0) {
      const float r = ra(S, row.ac, ri, cj);
      v = bi == 1 ? -r * h : -0.5f * r * h * h;
    } else if (bj == 1) {
      v = bi == 1 ? eye(ri, cj) : eye(ri, cj) * h;
    } else {
      v = bi == 2 ? eye(ri, cj) : 0.f;
    }
    A[t] = v;
  } else if (t < 135) {
    const int u = t - 81, i = u / 6, j = u % 6, ri = i % 3, cj = j % 3, bi = i / 3, bj = j / 3;
    float v = 0.f;
    if (bi == 0 && bj == 0) v = row.Jr[3 * ri + cj] * h;
    if (bi == 1 && bj == 1) v = S[kDR + 3 * ri + cj] * h;
    if (bi == 2 && bj == 1) v = 0.5f * S[kDR + 3 * ri + cj] * h * h;
    B[u] = v;
    Bq[u] = v * (bj == 0 ? row.qg : row.qa);
  } else if (t < 135 + 61) {
    const int u = t - 135;
    if (u < 9) {  // dR dR_inc
      const int r = u / 3, c = u % 3;
      float x = 0.f;
      for (int k = 0; k < 3; ++k) x += S[kDR + 3 * r + k] * row.dRi[3 * k + c];
      D[kDR + u] = x;
    } else if (u < 15) {  // dv + dR a_c h, dp + dv h + dR a_c h^2 / 2
      const int k = (u - 9) % 3;
      float m = 0.f;
      for (int l = 0; l < 3; ++l) m += S[kDR + 3 * k + l] * row.ac[l];
      if (u < 12) {
        D[kDV + k] = S[kDV + k] + m * h;
      } else {
        D[kDP + k] = S[kDP + k] + S[kDV + k] * h + 0.5f * m * h * h;
      }
    } else if (u < 60) {
      const int f = (u - 15) / 9, e = (u - 15) % 9, r = e / 3, c = e % 3;
      const float* J = S + kJdRbg;  // J_dR_bg
      if (f == 0) {  // dR_inc^T J_dR_bg - Jr h
        float x = 0.f;
        for (int k = 0; k < 3; ++k) x += row.dRi[3 * k + r] * J[3 * k + c];
        D[kJdRbg + e] = x - row.Jr[e] * h;
      } else if (f == 1) {  // J_dv_ba - dR h
        D[kJdvba + e] = S[kJdvba + e] - S[kDR + e] * h;
      } else if (f == 2) {  // J_dv_bg - Ra J_dR_bg h
        float x = 0.f;
        for (int k = 0; k < 3; ++k) x += ra(S, row.ac, r, k) * J[3 * k + c];
        D[kJdvbg + e] = S[kJdvbg + e] - x * h;
      } else if (f == 3) {  // J_dp_ba + J_dv_ba h - dR h^2 / 2
        D[kJdpba + e] = S[kJdpba + e] + S[kJdvba + e] * h - 0.5f * S[kDR + e] * h * h;
      } else {  // J_dp_bg + J_dv_bg h - Ra J_dR_bg h^2 / 2
        float x = 0.f;
        for (int k = 0; k < 3; ++k) x += 0.5f * ra(S, row.ac, r, k) * J[3 * k + c];
        D[kJdpbg + e] = S[kJdpbg + e] + S[kJdvbg + e] * h - x * h * h;
      }
    } else {
      D[kDt] = S[kDt] + h;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
imu_preint_kernel(const float* __restrict__ acc, const float* __restrict__ gyr,
                  const float* __restrict__ dt, const float* __restrict__ ba,
                  const float* __restrict__ bg, Init init, float* __restrict__ out, int N,
                  int acc_stride, int gyr_stride, int dt_stride, float gn2, float an2) {
  __shared__ Row rows[kThreads];
  __shared__ float st[2][kState];
  __shared__ float A[81], B[54], Bq[54], T[81];
  const int t = threadIdx.x;
  for (int e = t; e < kState; e += kThreads) st[0][e] = init_value(init, e);
  __syncthreads();
  int cur = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int n = min(kThreads, N - base);
    if (t < n) {
      const size_t i = base + t;
      row_terms(acc + i * acc_stride, gyr + i * gyr_stride, dt[i * dt_stride], ba, bg, gn2, an2,
                rows[t]);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const Row& row = rows[i];
      if (!(row.h > 0.f)) continue;  // padding: the same branch in every thread
      const float* S = st[cur];
      float* D = st[cur ^ 1];
      transitions_and_deltas(row, S, D, A, B, Bq, t);
      __syncthreads();
      if (t < 81) {  // A cov
        const int r = t / 9, c = t % 9;
        float x = 0.f;
        for (int k = 0; k < 9; ++k) x += A[9 * r + k] * S[kCov + 9 * k + c];
        T[t] = x;
      }
      __syncthreads();
      if (t < 81) {  // (A cov) A^T + (B q) B^T
        const int r = t / 9, c = t % 9;
        float x = 0.f, y = 0.f;
        for (int k = 0; k < 9; ++k) x += T[9 * r + k] * A[9 * c + k];
        for (int k = 0; k < 6; ++k) y += Bq[6 * r + k] * B[6 * c + k];
        D[kCov + t] = x + y;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  for (int e = t; e < kState; e += kThreads) out[e] = st[cur][e];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Device pointers to float32: acc and gyr (N,3) with row strides acc_stride
// and gyr_stride (elements) and contiguous rows, dt (N,) with stride
// dt_stride, ba and bg (3,); the ten fields of the preintegration to continue
// (dR (3,3), dv (3,), dp (3,), cov (9,9), the five (3,3) bias Jacobians, dt
// ()), contiguous; out (142,), written in the state layout above.  gyr_q and acc_q are the squared noise densities.
extern "C" int imu_preint_launch(const float* acc, const float* gyr, const float* dt,
                                 const float* ba, const float* bg, const float* dR,
                                 const float* dv, const float* dp, const float* cov,
                                 const float* J_dR_bg, const float* J_dv_ba,
                                 const float* J_dv_bg, const float* J_dp_ba,
                                 const float* J_dp_bg, const float* dt0, float* out, int N,
                                 int acc_stride, int gyr_stride, int dt_stride, float gyr_q,
                                 float acc_q, void* stream) {
  if (N < 0 || acc_stride < 0 || gyr_stride < 0 || dt_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Init init = {{dR, dv, dp, cov, J_dR_bg, J_dv_ba, J_dv_bg, J_dp_ba, J_dp_bg, dt0}};
  imu_preint_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, gyr, dt, ba, bg, init, out, N, acc_stride, gyr_stride, dt_stride, gyr_q, acc_q);
  return static_cast<int>(cudaGetLastError());
}
