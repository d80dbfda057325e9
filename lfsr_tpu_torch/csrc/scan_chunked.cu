// K1 / K2 — the selective scan with the dt projection folded in, and its
// training forward, as a chunk-parallel scan.
//
// K1 replaces lfsr_tpu/ops/pallas_scan.py::_scan_proj_kernel (the Pallas
// kernel behind selective_scan_proj). For every (batch b, channel d):
//   delta_t = softplus(dbc[t, :R] . Wdt[:, d] + bdt[d])
//   h_t[n]  = exp(delta_t A[d, n]) h_{t-1}[n] + B_t[n] delta_t u_t[d]
//   y_t[d]  = sum_n C_t[n] h_t[n] + D[d] u_t[d]
// with dbc = [dt_low_rank | B | C], the raw x_proj output. K2 replaces
// ::_scan_proj_states_kernel: the same passes (template flag kStates), which
// also write the state before every ``spacing``-th step,
// states[b, k, n, d] = h_{k*spacing - 1}[n] (0 for k = 0), float32. Its y
// is K1's bit for bit: the flag only adds the stores, and the wrapper gives
// both the same chunk length (ops/scan.py::scan_chunk_len).
//
// What bounds it on this card: per (b, t, d, n) one exp and a few FMAs, at
// Synth [4, 518400, 80], N 16, 2.65e9 of them. One warp walking a whole
// recurrence (csrc/scan.cu, still K9a-K9c's scan) puts only B x Di / 2 =
// 160 warps on a card that holds ~8,400: latency-bound. Here L is cut into
// chunks of Tc steps, so B x ceil(L / Tc) CTAs run at once, in three passes:
//  1. summaries (chunks 0 .. nc-2): each chunk's recurrence from h = 0; its
//     end state h_loc[b, c, n, d] and sum_t delta_t[b, c, d] (its decay is
//     exp(A[d, n] sum delta));
//  2. carry: per (b, n, d), in order over the chunks,
//     start[c + 1] = exp(A sum delta[c]) start[c] + h_loc[c], written over
//     h_loc[c] (so h_loc[c] then holds chunk c + 1's start state);
//  3. outputs: each chunk's recurrence again from its start state, y with
//     the D skip (and K2's states).
// Passes 1 and 3 each run the recurrence once; the carry is one FMA per
// (b, chunk, n, d). y is no longer the same bits as one step at a time over
// all of L: the carry composes rounded chunk states.
//
// Inside a chunk: a CTA owns a (b, chunk) and a group of channels. P lanes
// share a channel, each holding N / P states (and A for them) in
// registers; the sum over n is N / P FMAs and log2(P) shuffles. P is fixed
// by N (lfsr::scan_lanes in common.cuh: 1 up to N 8, 2 at the flagship's
// 16 and at 24, 4 at 32):
// with 16 states a lane a CTA of 80 channels is 3 warps and each step 16
// SFU issues in a row; P = N (the lane = (channel, n) layout of
// csrc/scan.cu) pays log2(N) shuffles a step. Tiles of kT steps of the
// CTA's dbc rows and u columns are staged in shared memory once for all its
// warps, as raw bytes by cp.async into two buffers: the next tile's copy is
// issued before this one is unpacked and stays in flight through its
// recurrence. The unpack converts B | C to float, computes the dt
// projection + softplus once per (t, d) and widens u; y goes back to shared
// memory and out in coalesced rows. Per (t, d, n) the step is an FMUL, one
// SFU ex2 (of delta x (A log2 e)), an FMUL and an FFMA, plus an FFMA for
// C h in pass 3, B and C read 4 states at a time.
#include "common.cuh"

namespace {

constexpr int kMaxR = 8;           // dt rank limit: ceil(C/16) <= 8 for C <= 128
constexpr int kT = 32;             // time steps per staged tile
constexpr int kMaxThreads = 512;   // CTA size limit: channels per CTA = 512 / P at most
constexpr int kMaxChannels = 256;  // and 256 at most (a float32 CTA's staging: ~140 KB)
constexpr int kUnroll = 8;         // the carry: chunks whose loads are issued together
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }
// a staged buffer's bytes: dbc, kT rows of at most kMaxR + 2N values in one
// run; u, kT rows of CG values (each row from the granule that holds its
// first value). 16 bytes more than the values for the first granule's offset
template <typename T>
__host__ __device__ constexpr int dbc_stage_bytes(int N) {
  return align16(kT * (kMaxR + 2 * N) * (int)sizeof(T)) + 16;
}
template <typename T>
__host__ __device__ constexpr int u_row_bytes(int cg) {
  return align16(cg * (int)sizeof(T)) + 16;
}

__device__ __forceinline__ const char* granule_of(const void* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}
// byte offset of p in its 16-byte granule (a multiple of the value size)
__device__ __forceinline__ int offset_in_granule(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Issue (no wait) the cp.async copies of one tile: dbc rows [t0, t0 + nt)
// of all K values, one run, to s_dbc; u rows [t0, t0 + nt), channels
// [d0, d0 + cgv), to s_u at a stride of ``row`` bytes. Whole 16-byte
// granules, each holding at least one value that is read
template <typename T>
__device__ __forceinline__ void stage_tile(char* s_dbc, char* s_u, const T* dbcb, const T* ub,
                                           int t0, int nt, int K, int Di, int d0, int cgv,
                                           int row) {
  const T* src = dbcb + (size_t)t0 * K;
  const char* g0 = granule_of(src);
  const int ng = (int)((reinterpret_cast<const char*>(src + (size_t)nt * K) - g0 + 15) / 16);
  for (int i = threadIdx.x; i < ng; i += blockDim.x) lfsr::cp_async16(s_dbc + 16 * i, g0 + 16 * i);
  const int gr = row / 16;  // granule slots per u row
  for (int i = threadIdx.x; i < nt * gr; i += blockDim.x) {
    const int r = i / gr, k = i % gr;
    const T* us = ub + (size_t)(t0 + r) * Di + d0;
    const char* g = granule_of(us) + 16 * k;
    if (g < reinterpret_cast<const char*>(us + cgv)) lfsr::cp_async16(s_u + r * row + 16 * k, g);
  }
}

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// NS consecutive floats of shared memory (16-byte aligned when NS % 4 == 0,
// 8-byte aligned when NS % 2 == 0)
template <int NS>
__device__ __forceinline__ void load_states(float (&v)[NS], const float* p) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (NS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x; v[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) v[i] = p[i];
  }
}

struct ChunkParams {
  const void* u;     // [B, L, Di]
  const void* dbc;   // [B, L, R + 2N]
  void* y;           // [B, L, Di] (pass 3)
  const float* wdt;  // [R, Di]
  const float* bdt;  // [Di]
  const float* A;    // [Di, N]
  const float* dskip;  // [Di] (pass 3)
  float* states;     // K2: [B, ceil(L / spacing), N, Di]
  float* hloc;       // [B, nc - 1, N, Di]: pass 1 writes end states, pass 2 start states
  float* dsum;       // [B, nc - 1, Di]
  int L, Di, R, spacing, Tc, nc;
};

// Pass 1 (kOut false) and pass 3 (kOut true): grid (channel groups, chunks,
// B), blockDim = round_up(channels per CTA x P, 32)
template <typename T, int N, int P, bool kOut, bool kStates>
__global__ void __launch_bounds__(kMaxThreads) chunk_scan_kernel(const ChunkParams p) {
  constexpr int NS = N / P;  // states per lane
  extern __shared__ __align__(16) float smem[];
  const int CG = blockDim.x / P;       // channels per CTA (lanes past Di idle)
  const int R = p.R, K = R + 2 * N, L = p.L, Di = p.Di;
  const int urow = u_row_bytes<T>(CG);
  float* s_bc = smem;                  // [kT][2N]: B | C of each staged step
  float* s_delta = s_bc + kT * 2 * N;  // [kT][CG]: delta, then (pass 3) y
  float* s_u = s_delta + kT * CG;      // [kT][CG]
  // the raw tiles, two of each: [2][dbc_stage_bytes], then [2][kT][urow]
  char* raw_dbc = reinterpret_cast<char*>(s_u + kT * CG);
  char* raw_u = raw_dbc + 2 * dbc_stage_bytes<T>(N);

  const int cc = threadIdx.x / P, part = threadIdx.x % P;
  const int d0 = blockIdx.x * CG, d = d0 + cc;
  const int c = blockIdx.y, b = blockIdx.z;
  const bool active = d < Di;
  const size_t bl = (size_t)b * L;
  const T* ub = static_cast<const T*>(p.u) + bl * Di;
  const T* dbcb = static_cast<const T*>(p.dbc) + bl * K;

  float a2[NS], h[NS];
  const size_t NDi = (size_t)N * Di;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int n = part * NS + i;
    a2[i] = active ? p.A[(size_t)d * N + n] * kLog2e : 0.f;
    // pass 3 starts from the carry's start state (chunk 0 from 0)
    h[i] = (kOut && c > 0 && active)
               ? p.hloc[((size_t)b * (p.nc - 1) + c - 1) * NDi + (size_t)n * Di + d]
               : 0.f;
  }
  const float d_skip = kOut && active ? p.dskip[d] : 0.f;
  float dsum = 0.f;
  float* sb = nullptr;
  if constexpr (kStates) sb = p.states + (size_t)b * ((L + p.spacing - 1) / p.spacing) * NDi;
  int until = 0;  // K2: steps until the next saved state (a chunk starts on one)

  const int cs = c * p.Tc, ce = min(L, cs + p.Tc);
  const int cgv = min(CG, Di - d0);  // channels of this CTA that exist
  stage_tile(raw_dbc, raw_u, dbcb, ub, cs, min(kT, ce - cs), K, Di, d0, cgv, urow);
  int buf = 0;
  for (int t0 = cs; t0 < ce; t0 += kT, buf ^= 1) {
    const int nt = min(kT, ce - t0);
    lfsr::cp_async_wait_all();
    __syncthreads();  // this tile has landed; the last one's shared memory is read
    // the next tile's copies run on through this one's unpack and recurrence
    if (t0 + kT < ce)
      stage_tile(raw_dbc + (buf ^ 1) * dbc_stage_bytes<T>(N), raw_u + (buf ^ 1) * kT * urow,
                 dbcb, ub, t0 + kT, min(kT, ce - t0 - kT), K, Di, d0, cgv, urow);
    const char* rd_buf = raw_dbc + buf * dbc_stage_bytes<T>(N);
    const char* ru_buf = raw_u + buf * kT * urow;
    const T* rd = reinterpret_cast<const T*>(rd_buf + offset_in_granule(dbcb + (size_t)t0 * K));
    for (int i = threadIdx.x; i < nt * 2 * N; i += blockDim.x)
      s_bc[i] = lfsr::load(rd + (i / (2 * N)) * K + R + i % (2 * N));
    // delta once per (t, d), in csrc/scan.cu's op order
    for (int i = threadIdx.x; i < nt * CG; i += blockDim.x) {
      const int tt = i / CG, j = i % CG, dd = d0 + j;
      float delta = 0.f, uu = 0.f;
      if (dd < Di) {
        const T* row = rd + tt * K;
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R) acc = fmaf(lfsr::load(row + r), p.wdt[(size_t)r * Di + dd], acc);
        delta = softplus(acc + p.bdt[dd]);
        const T* us = ub + (size_t)(t0 + tt) * Di + d0;
        uu = lfsr::load(reinterpret_cast<const T*>(ru_buf + tt * urow + offset_in_granule(us)) + j);
      }
      s_delta[i] = delta;
      s_u[i] = uu;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      if constexpr (kStates) {
        if (until == 0) {  // the state before step t0 + tt
          float* st = sb + (size_t)((t0 + tt) / p.spacing) * NDi + d;
          if (active) {
#pragma unroll
            for (int i = 0; i < NS; ++i) st[(size_t)(part * NS + i) * Di] = h[i];
          }
          until = p.spacing;
        }
        --until;
      }
      const float delta = s_delta[tt * CG + cc], uu = s_u[tt * CG + cc];
      const float du = delta * uu;
      float bv[NS], cv[NS];
      load_states<NS>(bv, s_bc + tt * 2 * N + part * NS);
      if constexpr (kOut) load_states<NS>(cv, s_bc + tt * 2 * N + N + part * NS);
      float part_y = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        h[i] = fmaf(lfsr::ex2(delta * a2[i]), h[i], bv[i] * du);
        if constexpr (kOut) part_y = fmaf(cv[i], h[i], part_y);
      }
      if constexpr (kOut) {
#pragma unroll
        for (int o = 1; o < P; o <<= 1) part_y += __shfl_xor_sync(0xffffffffu, part_y, o);
        // after the shuffle every lane of the channel has read its delta
        if (part == 0) s_delta[tt * CG + cc] = fmaf(uu, d_skip, part_y);
      } else {
        dsum += delta;
      }
    }
    if constexpr (kOut) {
      __syncthreads();
      T* yb = static_cast<T*>(p.y) + bl * Di;
      for (int i = threadIdx.x; i < nt * CG; i += blockDim.x) {
        const int dd = d0 + i % CG;
        if (dd < Di) lfsr::store(yb + (size_t)(t0 + i / CG) * Di + dd, s_delta[i]);
      }
    }
  }
  if constexpr (!kOut) {
    if (active) {
      const size_t bc = (size_t)b * (p.nc - 1) + c;
#pragma unroll
      for (int i = 0; i < NS; ++i) p.hloc[bc * NDi + (size_t)(part * NS + i) * Di + d] = h[i];
      if (part == 0) p.dsum[bc * Di + d] = dsum;
    }
  }
}

// Pass 2: one thread per (b, n, d) walks the nc - 1 summaries in order;
// kUnroll chunks' loads are issued before their FMAs
__global__ void chunk_carry_kernel(const float* __restrict__ A, float* __restrict__ hloc,
                                   const float* __restrict__ dsum, int B, int Di, int N,
                                   int chunks) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ND = (long long)N * Di;
  if (idx >= B * ND) return;
  const int b = (int)(idx / ND);
  const int r = (int)(idx % ND), n = r / Di, d = r % Di;
  const float a2 = A[(size_t)d * N + n] * kLog2e;
  float* hb = hloc + (size_t)b * chunks * ND + r;
  const float* sb = dsum + (size_t)b * chunks * Di + d;
  float carry = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += kUnroll) {
    float loc[kUnroll], s[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const bool in = c0 + k < chunks;
      loc[k] = in ? hb[(size_t)(c0 + k) * ND] : 0.f;
      s[k] = in ? sb[(size_t)(c0 + k) * Di] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (c0 + k < chunks) {
        carry = fmaf(lfsr::ex2(a2 * s[k]), carry, loc[k]);
        hb[(size_t)(c0 + k) * ND] = carry;  // the start state of chunk c0 + k + 1
      }
    }
  }
}

int threads_for(int Di, int P) {
  const int cg = min(Di, min(kMaxThreads / P, kMaxChannels));
  return (cg * P + 31) / 32 * 32;
}

template <typename T, int N, int P, bool kOut, bool kStates>
cudaError_t launch_pass(const ChunkParams& p, int B, int chunks, cudaStream_t s) {
  const int threads = threads_for(p.Di, P), cg = threads / P;
  const size_t smem = sizeof(float) * ((size_t)kT * 2 * N + 2 * (size_t)kT * cg) +
                      2 * (size_t)dbc_stage_bytes<T>(N) + 2 * (size_t)kT * u_row_bytes<T>(cg);
  auto* kernel = chunk_scan_kernel<T, N, P, kOut, kStates>;
  cudaError_t e = lfsr::set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((p.Di + cg - 1) / cg, chunks, B), threads, smem, s>>>(p);
  return cudaGetLastError();
}

// pass: 1 summaries, 3 outputs (kStates when p.states is set)
template <typename T, int N>
cudaError_t run_pass(const ChunkParams& p, int B, int pass, cudaStream_t s) {
  constexpr int P = lfsr::scan_lanes(N);
  if (pass == 1) return launch_pass<T, N, P, false, false>(p, B, p.nc - 1, s);
  if (p.states) return launch_pass<T, N, P, true, true>(p, B, p.nc, s);
  return launch_pass<T, N, P, true, false>(p, B, p.nc, s);
}

template <typename T>
cudaError_t by_state(const ChunkParams& p, int B, int N, int pass, cudaStream_t s) {
  switch (N) {
    case 4: return run_pass<T, 4>(p, B, pass, s);
    case 8: return run_pass<T, 8>(p, B, pass, s);
    case 16: return run_pass<T, 16>(p, B, pass, s);
    case 24: return run_pass<T, 24>(p, B, pass, s);
    case 32: return run_pass<T, 32>(p, B, pass, s);
    default: return cudaErrorInvalidValue;
  }
}

int pass_entry(const void* u, const void* dbc, const void* wdt, const void* bdt, const void* A,
               const void* dskip, void* hloc, void* dsum, void* y, void* states, int B, int L,
               int Di, int R, int N, int Tc, int spacing, int dtype, int pass, void* stream) {
  if (R < 1 || R > kMaxR || B < 1 || L < 1 || Di < 1 || Tc < 1 || spacing < 1 ||
      (states && Tc % spacing) || B > 65535)
    return cudaErrorInvalidValue;
  const int nc = (L + Tc - 1) / Tc;
  if (nc > 65535 || (nc > 1 && !hloc) || (pass == 1 && (nc == 1 || !dsum)))
    return cudaErrorInvalidValue;
  ChunkParams p{};
  p.u = u; p.dbc = dbc; p.y = y;
  p.wdt = static_cast<const float*>(wdt); p.bdt = static_cast<const float*>(bdt);
  p.A = static_cast<const float*>(A); p.dskip = static_cast<const float*>(dskip);
  p.states = static_cast<float*>(states);
  p.hloc = static_cast<float*>(hloc); p.dsum = static_cast<float*>(dsum);
  p.L = L; p.Di = Di; p.R = R; p.spacing = spacing; p.Tc = Tc; p.nc = nc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return by_state<float>(p, B, N, pass, s);
  if (dtype == lfsr::kBF16) return by_state<__nv_bfloat16>(p, B, N, pass, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Pass 1: hloc [B, nc - 1, N, Di] and dsum [B, nc - 1, Di] float32 scratch
// (nc = ceil(L / Tc) > 1). u and dbc contiguous, of ``dtype``.
LFSR_EXPORT int lfsr_chunk_scan_summaries(const void* u, const void* dbc, const void* wdt,
                                          const void* bdt, const void* A, void* hloc,
                                          void* dsum, int B, int L, int Di, int R, int N,
                                          int Tc, int dtype, void* stream) {
  return pass_entry(u, dbc, wdt, bdt, A, nullptr, hloc, dsum, nullptr, nullptr, B, L, Di, R, N,
                    Tc, 1, dtype, 1, stream);
}

// Pass 2: hloc and dsum of pass 1 with ``chunks`` = nc - 1 summaries each
LFSR_EXPORT int lfsr_chunk_scan_carry(const void* A, void* hloc, const void* dsum, int B,
                                      int Di, int N, int chunks, void* stream) {
  if (B < 1 || Di < 1 || N < 1 || chunks < 1) return cudaErrorInvalidValue;
  const long long total = (long long)B * N * Di;
  const int threads = 128;
  chunk_carry_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<float*>(hloc), static_cast<const float*>(dsum),
      B, Di, N, chunks);
  return cudaGetLastError();
}

// Pass 3: y [B, L, Di] of ``dtype``; with states (K2, float32 [B,
// ceil(L / spacing), N, Di]; Tc a multiple of spacing) the saved states
// too. hloc as after pass 2 (unused, and may be null, when nc = 1).
LFSR_EXPORT int lfsr_chunk_scan_outputs(const void* u, const void* dbc, const void* wdt,
                                        const void* bdt, const void* A, const void* dskip,
                                        void* hloc, void* y, void* states, int B, int L, int Di,
                                        int R, int N, int Tc, int spacing, int dtype,
                                        void* stream) {
  return pass_entry(u, dbc, wdt, bdt, A, dskip, hloc, nullptr, y, states, B, L, Di, R, N, Tc,
                    spacing, dtype, 3, stream);
}
