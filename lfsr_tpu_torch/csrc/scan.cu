// K1 — selective scan with the dt projection folded in.
//
// Replaces lfsr_tpu/ops/pallas_scan.py::_scan_proj_kernel (the Pallas kernel
// behind selective_scan_proj). For every (batch b, channel d):
//   delta_t = softplus(dbc[t, :R] . Wdt[:, d] + bdt[d])
//   h_t[n]  = exp(delta_t A[d, n]) h_{t-1}[n] + B_t[n] delta_t u_t[d]
//   y_t[d]  = sum_n C_t[n] h_t[n] + D[d] u_t[d]
// with dbc = [dt_low_rank | B | C], the raw x_proj output.
//
// What bounds it on this card: the recurrence is sequential in t, and at the
// tiled-eval point (B=2, Di=80, N=16, L=25600) there are only 2*80*16 = 2560
// scalar recurrences, a few warps for a 132-SM card. The inputs are ~12 MB,
// so it is latency-bound (one dependent step after another), not
// bandwidth-bound.
//
// Design: the TPU kernel carries the state across a sequential grid axis;
// Hopper's blocks run in no order, so a block owns whole (b, d) recurrences
// and loops over L itself.
//  - One warp per block. Lane = (channel-in-warp, state n): 32/N channels per
//    warp, the N states of a channel on N lanes, each lane holding its h[n] in
//    a register. The sum over n for y is a shuffle butterfly over those lanes.
//    Spreading the states over lanes puts Di*B/2 = 80 warps on 80 SMs and
//    keeps each step's dependent chain to one exp, one FMA and the butterfly.
//  - The dbc rows of a kTile-step time tile are staged in shared memory once
//    and read by all lanes; delta and delta*u of the tile are computed in a
//    pre-pass, one softplus per (t, d) instead of one per lane.
// All arithmetic is float32; u, dbc and y are float32 or bfloat16.
// A chunk-parallel two-pass scan, to put more blocks in flight, is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 128;  // time steps staged per tile
constexpr int kMaxR = 8;    // dt rank limit: ceil(C/16) <= 8 for C <= 128

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename T, int N>
__global__ void __launch_bounds__(32)
scan_proj_kernel(const T* __restrict__ u, const T* __restrict__ dbc,
                 const float* __restrict__ wdt, const float* __restrict__ bdt,
                 const float* __restrict__ A, const float* __restrict__ dskip,
                 T* __restrict__ y, int L, int Di, int R) {
  constexpr int CPW = 32 / N;  // channels per warp
  extern __shared__ float smem[];
  const int K = R + 2 * N;
  float* s_dbc = smem;                  // [kTile][K]
  float* s_delta = s_dbc + kTile * K;   // [kTile][CPW]
  float* s_du = s_delta + kTile * CPW;  // [kTile][CPW]
  float* s_u = s_du + kTile * CPW;      // [kTile][CPW]

  const int lane = threadIdx.x;
  const int n = lane % N;
  const int cl = lane / N;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPW;
  const int d = d0 + cl;
  const bool active = d < Di;

  const float a_n = active ? A[(size_t)d * N + n] : 0.f;
  const float d_skip = active ? dskip[d] : 0.f;
  float h = 0.f;

  const T* ub = u + (size_t)b * L * Di;
  const T* dbcb = dbc + (size_t)b * L * K;
  T* yb = y + (size_t)b * L * Di;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nt = min(kTile, L - t0);
    __syncwarp();
    for (int i = lane; i < nt * K; i += 32) s_dbc[i] = lfsr::load(dbcb + (size_t)t0 * K + i);
    __syncwarp();
    // pre-pass: delta, delta*u and u for every (t, channel) of the tile
    for (int i = lane; i < nt * CPW; i += 32) {
      const int tt = i / CPW;
      const int dd = d0 + i % CPW;
      float delta = 0.f, uu = 0.f;
      if (dd < Di) {
        const float* row = s_dbc + tt * K;
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R) acc = fmaf(row[r], wdt[(size_t)r * Di + dd], acc);
        delta = softplus(acc + bdt[dd]);
        uu = lfsr::load(ub + (size_t)(t0 + tt) * Di + dd);
      }
      s_delta[i] = delta;
      s_du[i] = delta * uu;
      s_u[i] = uu;
    }
    __syncwarp();
    for (int tt = 0; tt < nt; ++tt) {
      const float* row = s_dbc + tt * K;
      const int ti = tt * CPW + cl;
      h = fmaf(expf(s_delta[ti] * a_n), h, row[R + n] * s_du[ti]);
      float part = row[R + N + n] * h;
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (n == 0 && active)
        lfsr::store(yb + (size_t)(t0 + tt) * Di + d, fmaf(s_u[ti], d_skip, part));
    }
  }
}

template <typename T, int N>
cudaError_t launch_scan(const void* u, const void* dbc, const void* wdt, const void* bdt,
                        const void* A, const void* dskip, void* y, int B, int L, int Di,
                        int R, cudaStream_t stream) {
  constexpr int CPW = 32 / N;
  const int K = R + 2 * N;
  const size_t smem = sizeof(float) * (size_t)kTile * (K + 3 * CPW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(scan_proj_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Di + CPW - 1) / CPW, B);
  scan_proj_kernel<T, N><<<grid, 32, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dbc), static_cast<const float*>(wdt),
      static_cast<const float*>(bdt), static_cast<const float*>(A),
      static_cast<const float*>(dskip), static_cast<T*>(y), L, Di, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* u, const void* dbc, const void* wdt, const void* bdt,
                       const void* A, const void* dskip, void* y, int B, int L, int Di, int R,
                       int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch_scan<T, 4>(u, dbc, wdt, bdt, A, dskip, y, B, L, Di, R, s);
    case 8: return launch_scan<T, 8>(u, dbc, wdt, bdt, A, dskip, y, B, L, Di, R, s);
    case 16: return launch_scan<T, 16>(u, dbc, wdt, bdt, A, dskip, y, B, L, Di, R, s);
    case 32: return launch_scan<T, 32>(u, dbc, wdt, bdt, A, dskip, y, B, L, Di, R, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFSR_EXPORT int lfsr_scan_proj(const void* u, const void* dbc, const void* wdt, const void* bdt,
                               const void* A, const void* dskip, void* y, int B, int L, int Di,
                               int R, int N, int dtype, void* stream) {
  if (R < 1 || R > kMaxR || B < 1 || L < 1 || Di < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return dispatch_n<float>(u, dbc, wdt, bdt, A, dskip, y, B, L, Di, R, N, s);
  if (dtype == lfsr::kBF16)
    return dispatch_n<__nv_bfloat16>(u, dbc, wdt, bdt, A, dskip, y, B, L, Di, R, N, s);
  return cudaErrorInvalidValue;
}

LFSR_EXPORT const char* lfsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
