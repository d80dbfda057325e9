// K1 / K2 / K3 — selective scan with the dt projection folded in, its
// training forward and its adjoint.
//
// K1 replaces lfsr_tpu/ops/pallas_scan.py::_scan_proj_kernel (the Pallas
// kernel behind selective_scan_proj). For every (batch b, channel d):
//   delta_t = softplus(dbc[t, :R] . Wdt[:, d] + bdt[d])
//   h_t[n]  = exp(delta_t A[d, n]) h_{t-1}[n] + B_t[n] delta_t u_t[d]
//   y_t[d]  = sum_n C_t[n] h_t[n] + D[d] u_t[d]
// with dbc = [dt_low_rank | B | C], the raw x_proj output.
//
// K2 replaces ::_scan_proj_states_kernel: the same kernel (template flag
// kStates), which also writes the state before every ``spacing``-th step,
// states[b, k, n, d] = h_{k*spacing - 1}[n] (0 for k = 0), float32. Its y
// is K1's bit for bit: the flag only adds the stores.
//
// K3 replaces ::_scan_proj_bwd_kernel, the reverse adjoint scan. Given dy,
// lambda_t = C_t dy_t + exp(delta_{t+1} A) lambda_{t+1} and it returns
//   du_t[d]  = delta_t sum_n lambda_t B_t          (the scan's part of du)
//   ddt_t[d] = sum_n lambda_t A exp(delta_t A) h_{t-1} + u_t sum_n lambda_t B_t
//   dB_t[n]  = sum_d lambda_t delta_t u_t,   dC_t[n] = sum_d h_t dy_t
//   dA[b, n, d] = sum_t lambda_t exp(delta_t A) h_{t-1} delta_t
// all float32; the dt-projection chain and the D skip are left to PyTorch.
//
// What bounds them on this card: the recurrence is sequential in t. At the
// training point (B=8, Di=80, N=16, L=25600) there are 8*80*16 = 10240
// scalar recurrences, a few warps per SM, so every kernel here is
// latency-bound (one dependent step after another), not bandwidth-bound.
//
// Design: the TPU kernel carries the state across a sequential grid axis;
// Hopper's blocks run in no order, so a warp owns whole (b, d) recurrences
// and loops over L itself.
//  - Lane = (channel-in-warp, state n): 32/N channels per warp, the N states
//    of a channel on N lanes, each lane holding its h[n] in a register. The
//    sum over n is a shuffle butterfly over those lanes.
//  - The dbc rows of a time tile are staged in shared memory once and read
//    by all lanes; delta and delta*u are computed in a pre-pass, one
//    softplus per (t, d) instead of one per lane.
//  - K3 cannot carry the adjoint across a reversed grid axis either: its
//    warp walks the chunks of ``spacing`` = kBwdChunk steps from the end.
//    For each chunk it recomputes the chunk's states from K2's saved
//    start state into shared memory, then runs the adjoint backwards.
//    dB and dC sum over all Di channels, which cross warps: each warp sums
//    its own channels by shuffles, the kBwdWarps warps of a block add
//    theirs in shared memory, and every block writes its partial sums to a
//    float32 scratch [B, blocks, L, N]; a second kernel adds the blocks'
//    partials in a fixed order. No atomics: the result is the same from
//    run to run. The order (lanes, then warps, then blocks) is not the
//    twin's, so dB/dC differ from it by float32 rounding only; the checks
//    hold every K3 output to 1e-4 of its own scale max(1, max|twin|).
// All arithmetic is float32; u, dbc, dy and y are float32 or bfloat16.
// A chunk-parallel two-pass scan, to put more blocks in flight, is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 128;      // time steps staged per tile (K1, K2)
constexpr int kMaxR = 8;        // dt rank limit: ceil(C/16) <= 8 for C <= 128
constexpr int kBwdChunk = 64;   // K3: steps per chunk == the state spacing it takes
constexpr int kBwdWarps = 4;    // K3: warps per block

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// delta for channel dd from a staged dbc row (the same op order in K1-K3)
__device__ __forceinline__ float delta_of(const float* row, const float* __restrict__ wdt,
                                          const float* __restrict__ bdt, int dd, int R,
                                          int Di) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    if (r < R) acc = fmaf(row[r], wdt[(size_t)r * Di + dd], acc);
  return softplus(acc + bdt[dd]);
}

template <typename T, int N, bool kStates>
__global__ void __launch_bounds__(32)
scan_proj_kernel(const T* __restrict__ u, const T* __restrict__ dbc,
                 const float* __restrict__ wdt, const float* __restrict__ bdt,
                 const float* __restrict__ A, const float* __restrict__ dskip,
                 T* __restrict__ y, float* __restrict__ states, int L, int Di, int R,
                 int spacing) {
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
  float* sb = nullptr;
  if constexpr (kStates) sb = states + (size_t)b * ((L + spacing - 1) / spacing) * N * Di;
  int until = 0;  // K2: steps until the next block start

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
        delta = delta_of(s_dbc + tt * K, wdt, bdt, dd, R, Di);
        uu = lfsr::load(ub + (size_t)(t0 + tt) * Di + dd);
      }
      s_delta[i] = delta;
      s_du[i] = delta * uu;
      s_u[i] = uu;
    }
    __syncwarp();
    for (int tt = 0; tt < nt; ++tt) {
      if constexpr (kStates) {
        if (until == 0) {  // the state before step t0 + tt starts a block
          if (active) sb[((size_t)((t0 + tt) / spacing) * N + n) * Di + d] = h;
          until = spacing;
        }
        --until;
      }
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
__global__ void __launch_bounds__(32 * kBwdWarps)
scan_proj_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dbc,
                     const T* __restrict__ dy, const float* __restrict__ wdt,
                     const float* __restrict__ bdt, const float* __restrict__ A,
                     const float* __restrict__ states, float* __restrict__ du,
                     float* __restrict__ ddt, float* __restrict__ dA_part,
                     float* __restrict__ part_b, float* __restrict__ part_c, int L, int Di,
                     int R) {
  constexpr int CPW = 32 / N;
  constexpr int TC = kBwdChunk;
  constexpr int kPerWarp = 3 * TC * CPW + TC * 32 + 2 * TC * N;
  extern __shared__ float smem[];
  const int K = R + 2 * N;
  const int W = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* s_dbc = smem;                                   // [TC][K], shared by the block
  float* s_warps = s_dbc + TC * K;                       // W x kPerWarp
  float* s_delta = s_warps + warp * kPerWarp;            // [TC][CPW]
  float* s_u = s_delta + TC * CPW;                       // [TC][CPW]
  float* s_dy = s_u + TC * CPW;                          // [TC][CPW]
  float* s_h = s_dy + TC * CPW;                          // [TC][32]: h_t of every lane
  float* s_pb = s_h + TC * 32;                           // [TC][N]: this warp's dB sums
  float* s_pc = s_pb + TC * N;                           // [TC][N]: this warp's dC sums

  const int n = lane % N;
  const int cl = lane / N;
  const int b = blockIdx.y;
  const int d0 = (blockIdx.x * W + warp) * CPW;
  const int d = d0 + cl;
  const bool active = d < Di;
  const int nb = (L + TC - 1) / TC;
  const float a_n = active ? A[(size_t)d * N + n] : 0.f;

  const T* ub = u + (size_t)b * L * Di;
  const T* dbcb = dbc + (size_t)b * L * K;
  const T* dyb = dy + (size_t)b * L * Di;
  float* dub = du + (size_t)b * L * Di;
  float* ddtb = ddt + (size_t)b * L * Di;
  float* pbb = part_b + ((size_t)b * gridDim.x + blockIdx.x) * L * N;
  float* pcb = part_c + ((size_t)b * gridDim.x + blockIdx.x) * L * N;
  const float* sb = states + (size_t)b * nb * N * Di;

  float mu = 0.f;      // exp(delta_{t+1} A) lambda_{t+1}, carried backwards
  float da_acc = 0.f;  // dA[b, n, d]
  for (int k = nb - 1; k >= 0; --k) {
    const int t0 = k * TC;
    const int nt = min(TC, L - t0);
    __syncthreads();  // the previous chunk's shared memory is read
    for (int i = threadIdx.x; i < nt * K; i += blockDim.x)
      s_dbc[i] = lfsr::load(dbcb + (size_t)t0 * K + i);
    __syncthreads();
    for (int i = lane; i < nt * CPW; i += 32) {
      const int tt = i / CPW;
      const int dd = d0 + i % CPW;
      float delta = 0.f, uu = 0.f, g = 0.f;  // 0 on channels past Di: no contribution
      if (dd < Di) {
        delta = delta_of(s_dbc + tt * K, wdt, bdt, dd, R, Di);
        uu = lfsr::load(ub + (size_t)(t0 + tt) * Di + dd);
        g = lfsr::load(dyb + (size_t)(t0 + tt) * Di + dd);
      }
      s_delta[i] = delta;
      s_u[i] = uu;
      s_dy[i] = g;
    }
    __syncwarp();
    // forward: the chunk's states from its saved start state (K2's ops)
    const float h0 = active ? sb[((size_t)k * N + n) * Di + d] : 0.f;
    float h = h0;
    for (int tt = 0; tt < nt; ++tt) {
      const float* row = s_dbc + tt * K;
      const int ti = tt * CPW + cl;
      h = fmaf(expf(s_delta[ti] * a_n), h, row[R + n] * (s_delta[ti] * s_u[ti]));
      s_h[tt * 32 + lane] = h;
    }
    __syncwarp();
    // backward: the adjoint from the chunk's end to its start
    for (int tt = nt - 1; tt >= 0; --tt) {
      const float* row = s_dbc + tt * K;
      const int ti = tt * CPW + cl;
      const float delta = s_delta[ti], uu = s_u[ti], g = s_dy[ti];
      const float dA = expf(delta * a_n);
      const float hprev = tt > 0 ? s_h[(tt - 1) * 32 + lane] : h0;
      const float lam = fmaf(row[R + N + n], g, mu);
      const float w = lam * dA * hprev;
      da_acc = fmaf(w, delta, da_acc);
      float s1 = lam * row[R + n];
      float wa = w * a_n;
      float pb = lam * (delta * uu);
      float pc = s_h[tt * 32 + lane] * g;
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) {  // over the N states of a channel
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        wa += __shfl_xor_sync(0xffffffffu, wa, o);
      }
#pragma unroll
      for (int o = 16; o >= N; o >>= 1) {  // over the warp's channels
        pb += __shfl_xor_sync(0xffffffffu, pb, o);
        pc += __shfl_xor_sync(0xffffffffu, pc, o);
      }
      if (n == 0 && active) {
        dub[(size_t)(t0 + tt) * Di + d] = s1 * delta;
        ddtb[(size_t)(t0 + tt) * Di + d] = fmaf(s1, uu, wa);
      }
      if (cl == 0) {
        s_pb[tt * N + n] = pb;
        s_pc[tt * N + n] = pc;
      }
      mu = dA * lam;
    }
    __syncthreads();
    // the block's dB / dC partials: its warps' sums, added in warp order
    for (int i = threadIdx.x; i < nt * N; i += blockDim.x) {
      float vb = 0.f, vc = 0.f;
      for (int w2 = 0; w2 < W; ++w2) {
        const float* sw = s_warps + w2 * kPerWarp + 3 * TC * CPW + TC * 32;
        vb += sw[i];
        vc += sw[TC * N + i];
      }
      pbb[(size_t)t0 * N + i] = vb;
      pcb[(size_t)t0 * N + i] = vc;
    }
  }
  if (active) dA_part[((size_t)b * N + n) * Di + d] = da_acc;
}

// out[b, i] = sum over x of part[b, x, i], x in order (i < LN)
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int parts, long long LN, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / LN, r = i % LN;
  const float* p = part + b * parts * LN + r;
  float s = 0.f;
  for (int x = 0; x < parts; ++x) s += p[x * LN];
  out[i] = s;
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int N, bool kStates>
cudaError_t launch_scan(const void* u, const void* dbc, const void* wdt, const void* bdt,
                        const void* A, const void* dskip, void* y, void* states, int B,
                        int L, int Di, int R, int spacing, cudaStream_t stream) {
  constexpr int CPW = 32 / N;
  const int K = R + 2 * N;
  const size_t smem = sizeof(float) * (size_t)kTile * (K + 3 * CPW);
  cudaError_t e = set_smem((const void*)scan_proj_kernel<T, N, kStates>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Di + CPW - 1) / CPW, B);
  scan_proj_kernel<T, N, kStates><<<grid, 32, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dbc), static_cast<const float*>(wdt),
      static_cast<const float*>(bdt), static_cast<const float*>(A),
      static_cast<const float*>(dskip), static_cast<T*>(y), static_cast<float*>(states), L,
      Di, R, spacing);
  return cudaGetLastError();
}

template <typename T, bool kStates>
cudaError_t dispatch_n(const void* u, const void* dbc, const void* wdt, const void* bdt,
                       const void* A, const void* dskip, void* y, void* states, int B, int L,
                       int Di, int R, int N, int spacing, cudaStream_t s) {
  switch (N) {
    case 4: return launch_scan<T, 4, kStates>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, spacing, s);
    case 8: return launch_scan<T, 8, kStates>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, spacing, s);
    case 16: return launch_scan<T, 16, kStates>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, spacing, s);
    case 32: return launch_scan<T, 32, kStates>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, spacing, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kStates>
cudaError_t scan_entry(const void* u, const void* dbc, const void* wdt, const void* bdt,
                       const void* A, const void* dskip, void* y, void* states, int B, int L,
                       int Di, int R, int N, int spacing, int dtype, void* stream) {
  if (R < 1 || R > kMaxR || B < 1 || L < 1 || Di < 1 || spacing < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return dispatch_n<float, kStates>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, N, spacing, s);
  if (dtype == lfsr::kBF16)
    return dispatch_n<__nv_bfloat16, kStates>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, N, spacing, s);
  return cudaErrorInvalidValue;
}

template <typename T, int N>
cudaError_t launch_bwd(const void* u, const void* dbc, const void* dy, const void* wdt,
                       const void* bdt, const void* A, const void* states, void* du, void* ddt,
                       void* dB, void* dC, void* dA, void* part_b, void* part_c, int B, int L,
                       int Di, int R, cudaStream_t stream) {
  constexpr int CPW = 32 / N;
  const int K = R + 2 * N;
  const int W = min(kBwdWarps, (Di + CPW - 1) / CPW);
  const int gx = (Di + CPW * W - 1) / (CPW * W);
  const size_t per_warp = 3 * kBwdChunk * CPW + kBwdChunk * 32 + 2 * kBwdChunk * N;
  const size_t smem = sizeof(float) * ((size_t)kBwdChunk * K + W * per_warp);
  cudaError_t e = set_smem((const void*)scan_proj_bwd_kernel<T, N>, smem);
  if (e != cudaSuccess) return e;
  scan_proj_bwd_kernel<T, N><<<dim3(gx, B), 32 * W, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dbc), static_cast<const T*>(dy),
      static_cast<const float*>(wdt), static_cast<const float*>(bdt),
      static_cast<const float*>(A), static_cast<const float*>(states), static_cast<float*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(part_b),
      static_cast<float*>(part_c), L, Di, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long LN = (long long)L * N, total = (long long)B * LN;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sum_parts_kernel<<<blocks, threads, 0, stream>>>(static_cast<const float*>(part_b),
                                                   static_cast<float*>(dB), gx, LN, total);
  sum_parts_kernel<<<blocks, threads, 0, stream>>>(static_cast<const float*>(part_c),
                                                   static_cast<float*>(dC), gx, LN, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* u, const void* dbc, const void* dy, const void* wdt,
                         const void* bdt, const void* A, const void* states, void* du,
                         void* ddt, void* dB, void* dC, void* dA, void* pb, void* pc, int B,
                         int L, int Di, int R, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch_bwd<T, 4>(u, dbc, dy, wdt, bdt, A, states, du, ddt, dB, dC, dA, pb, pc, B, L, Di, R, s);
    case 8: return launch_bwd<T, 8>(u, dbc, dy, wdt, bdt, A, states, du, ddt, dB, dC, dA, pb, pc, B, L, Di, R, s);
    case 16: return launch_bwd<T, 16>(u, dbc, dy, wdt, bdt, A, states, du, ddt, dB, dC, dA, pb, pc, B, L, Di, R, s);
    case 32: return launch_bwd<T, 32>(u, dbc, dy, wdt, bdt, A, states, du, ddt, dB, dC, dA, pb, pc, B, L, Di, R, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFSR_EXPORT int lfsr_scan_proj(const void* u, const void* dbc, const void* wdt, const void* bdt,
                               const void* A, const void* dskip, void* y, int B, int L, int Di,
                               int R, int N, int dtype, void* stream) {
  return scan_entry<false>(u, dbc, wdt, bdt, A, dskip, y, nullptr, B, L, Di, R, N, 1, dtype,
                           stream);
}

LFSR_EXPORT int lfsr_scan_proj_states(const void* u, const void* dbc, const void* wdt,
                                      const void* bdt, const void* A, const void* dskip,
                                      void* y, void* states, int B, int L, int Di, int R,
                                      int N, int spacing, int dtype, void* stream) {
  return scan_entry<true>(u, dbc, wdt, bdt, A, dskip, y, states, B, L, Di, R, N, spacing,
                          dtype, stream);
}

// part_b / part_c: float32 scratch of B * ceil(Di / (channels per block)) * L * N
// each (the wrapper sizes it with the same rule, lfsr_scan_bwd_parts).
LFSR_EXPORT int lfsr_scan_proj_bwd(const void* u, const void* dbc, const void* dy,
                                   const void* wdt, const void* bdt, const void* A,
                                   const void* states, void* du, void* ddt, void* dB, void* dC,
                                   void* dA, void* part_b, void* part_c, int B, int L, int Di,
                                   int R, int N, int spacing, int dtype, void* stream) {
  if (R < 1 || R > kMaxR || B < 1 || L < 1 || Di < 1 || spacing != kBwdChunk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return dispatch_bwd<float>(u, dbc, dy, wdt, bdt, A, states, du, ddt, dB, dC, dA, part_b,
                               part_c, B, L, Di, R, N, s);
  if (dtype == lfsr::kBF16)
    return dispatch_bwd<__nv_bfloat16>(u, dbc, dy, wdt, bdt, A, states, du, ddt, dB, dC, dA,
                                       part_b, part_c, B, L, Di, R, N, s);
  return cudaErrorInvalidValue;
}

// the number of blocks along Di that K3 launches (its scratch's second axis)
LFSR_EXPORT int lfsr_scan_bwd_parts(int Di, int N) {
  if (N != 4 && N != 8 && N != 16 && N != 32) return -1;
  const int cpw = 32 / N;
  const int w = (Di + cpw - 1) / cpw < kBwdWarps ? (Di + cpw - 1) / cpw : kBwdWarps;
  return (Di + cpw * w - 1) / (cpw * w);
}

LFSR_EXPORT const char* lfsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
