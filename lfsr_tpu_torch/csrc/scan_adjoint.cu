// K3 — the adjoint of K1 / K2, as a chunk-parallel reverse scan.
//
// K3 replaces lfsr_tpu/ops/pallas_scan.py::_scan_proj_bwd_kernel, the
// reverse adjoint scan of K1 (delta_t = softplus(dbc[t, :R] . Wdt[:, d] +
// bdt[d]) from dbc = [dt_low_rank | B | C]), seeded from the states K2 saved
// every ``spacing`` = kChunk steps. Given dy,
//   lambda_t = C_t dy_t + exp(delta_{t+1} A) lambda_{t+1}
// and it returns, all float32,
//   du_t[d]  = delta_t sum_n lambda_t B_t          (the scan's part of du)
//   ddt_t[d] = sum_n lambda_t A exp(delta_t A) h_{t-1} + u_t sum_n lambda_t B_t
//   dB_t[n]  = sum_d lambda_t delta_t u_t,   dC_t[n] = sum_d h_t dy_t
//   dA[b, n, d] = sum_t lambda_t exp(delta_t A) h_{t-1} delta_t
// the dt-projection chain and the D skip are left to PyTorch.
//
// What bounds it on this card: the recurrence is sequential in t, and at
// the training point (B 8, L 25600, Di 80, N 16) one warp per channel pair
// walking all of L is 320 warps on a card that holds ~8,400: latency-bound.
// What crosses a chunk of kChunk steps is only the carry
// mu = exp(delta_t A) lambda_t, and it is linear: with mu_in[k] the carry
// that enters chunk k from chunk k + 1 (0 for the last) and
// S[k] = sum_{t in k} delta_t,
//   mu_out[k] = m_loc[k] + exp(A S[k]) mu_in[k],   mu_in[k] = mu_out[k + 1]
// where m_loc[k] is the chunk's own walk from mu = 0. So K3 is:
//  A. summaries (chunks 1 .. nc-1, one CTA per (channel group, chunk, b)):
//     each chunk's lambda-only walk back from mu = 0; m_loc and S written at
//     the reversed index r = nc - 1 - k in K1's summary layout,
//     [B, nc - 1, N, Di] and [B, nc - 1, Di];
//  B. the carry: csrc/scan_chunked.cu's lfsr_chunk_scan_carry, unchanged.
//     Walked over r it leaves at r the carry of chunks nc - 1 .. nc - 1 - r,
//     which is mu_in of chunk nc - 2 - r;
//  C. the adjoint (one CTA per (chunk, b)): each chunk's states recomputed
//     from K2's saved start state into shared memory, then the adjoint
//     walked back from mu_in; du and ddt written, dA per chunk;
//  D. the chunks' dA summed in chunk order.
// The carry composes rounded chunk adjoints, so du, ddt and dA are not the
// bits of one walk over all of L; the checks hold every output to 1e-4 of
// its own scale max(1, max|twin|).
//
// Inside pass A: P lanes share a channel (lfsr::scan_lanes, as K1), each holding
// N / P carries in registers; the walk needs no shuffle. A thread's dy loads
// of the pre-pass are issued together, its dt weights held in registers.
// Inside pass C: lane = (channel-in-warp, state n), 32 / NP channels per
// warp, the N states of a channel on NP = lfsr::state_span(N) lanes (N, or
// 32 at N 24, where lanes n >= 24 hold h = 0 and mu = 0 and add 0); the
// sums over n are shuffle butterflies. Both walks go kG steps at a time: the steps' shared-memory
// reads and exps first, then the dependent chain (h forwards, mu
// backwards: one FMA and one multiply a step), then (backwards) the kG
// steps' butterflies interleaved, so a warp waits on one chain of
// latencies per kG steps instead of per step. Two sums share each
// butterfly (a lane keeps one, sends the other at the first level): 6
// shuffles a step at N 16 instead of 10. Per step a lane reads its
// channel's (delta, u, dy, delta u) as one float4 and its (B, C) as one
// float2. dB and dC sum over all Di channels, so the CTA walks all channel
// groups of its chunk (kWarps x 32 / NP channels each) in turn, the next
// group's u and dy loads in flight through this group's walks: each warp
// sums its channels by shuffles and keeps the sums in the rows of its h_t
// it has walked past; each thread adds the group's warps' sums, in warp
// order, to the dB/dC values it holds in registers; the chunk's rows of dB
// and dC are written once at the end. No partials across CTAs and no
// atomics: two calls give the same bits. At N 16 a CTA holds ~49 KB of
// shared memory and 128 registers a thread: 4 CTAs, 16 warps an SM.
// All arithmetic is float32; u, dbc and dy are float32 or bfloat16.
#include "common.cuh"

namespace {

constexpr int kMaxR = 8;           // dt rank limit: ceil(C/16) <= 8 for C <= 128
constexpr int kChunk = 64;         // steps per chunk == the state spacing it takes
constexpr int kWarps = 4;          // pass C: warps per CTA
constexpr int kG = 4;              // pass C: steps walked as one group
constexpr int kMaxThreads = 512;   // pass A: threads per CTA at most,
constexpr int kMaxChannels = 128;  // and channels (its staging: ~66 KB at 128)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// delta from a staged dbc row and one channel's dt weights w[:R] and bias
// (the op order of K1 and K2)
__device__ __forceinline__ float delta_from(const float* row, const float (&w)[kMaxR],
                                            float bias, int R) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    if (r < R) acc = fmaf(row[r], w[r], acc);
  return softplus(acc + bias);
}

// the same for channel dd, its weights read from Wdt [R, Di] and bdt
__device__ __forceinline__ float delta_of(const float* row, const float* __restrict__ wdt,
                                          const float* __restrict__ bdt, int dd, int R,
                                          int Di) {
  float w[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) w[r] = r < R ? wdt[(size_t)r * Di + dd] : 0.f;
  return delta_from(row, w, bdt[dd], R);
}

struct AdjParams {
  const void* u;       // [B, L, Di]
  const void* dbc;     // [B, L, R + 2N]
  const void* dy;      // [B, L, Di]
  const float* wdt;    // [R, Di]
  const float* bdt;    // [Di]
  const float* A;      // [Di, N]
  const float* states; // [B, nc, N, Di]: K2's state before each chunk
  float* mloc;         // [B, nc - 1, N, Di]: pass A's m_loc, after pass B the carries
  float* dsum;         // [B, nc - 1, Di]
  float* du;           // [B, L, Di]
  float* ddt;          // [B, L, Di]
  float* dB;           // [B, L, N]
  float* dC;           // [B, L, N]
  float* dA;           // [B, nc, N, Di]: each chunk's dA (dA itself when nc = 1)
  int L, Di, R, nc;
};

// Pass A: grid (channel groups, nc - 1, B), CG x P threads
template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads) adjoint_summary_kernel(const AdjParams p) {
  constexpr int P = lfsr::scan_lanes(N), NS = N / P;
  constexpr int kRows = 16;  // the pre-pass's steps per thread whose loads go together
  extern __shared__ __align__(16) float smem[];
  const int CG = blockDim.x / P;  // channels per CTA (those past Di idle)
  const int R = p.R, K = R + 2 * N, L = p.L, Di = p.Di;
  float* s_dbc = smem;                   // [kChunk][K]
  float* s_delta = s_dbc + kChunk * K;   // [kChunk][CG]
  float* s_dy = s_delta + kChunk * CG;   // [kChunk][CG]
  const int cc = threadIdx.x / P, part = threadIdx.x % P;
  const int d0 = blockIdx.x * CG, d = d0 + cc;
  const int k = blockIdx.y + 1, b = blockIdx.z;
  const int t0 = k * kChunk, nt = min(kChunk, L - t0);
  const bool active = d < Di;

  const T* rows = static_cast<const T*>(p.dbc) + ((size_t)b * L + t0) * K;
  for (int i = threadIdx.x; i < nt * K; i += blockDim.x) s_dbc[i] = lfsr::load(rows + i);
  __syncthreads();
  {  // delta and dy of every step: a thread owns one channel and every P-th step
    const int c = threadIdx.x % CG, dd = d0 + c;
    const bool ok = dd < Di;
    float w[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) w[r] = ok && r < R ? p.wdt[(size_t)r * Di + dd] : 0.f;
    const float bias = ok ? p.bdt[dd] : 0.f;
    const T* dyc = static_cast<const T*>(p.dy) + ((size_t)b * L + t0) * Di + dd;
    for (int m0 = threadIdx.x / CG; m0 < nt; m0 += kRows * P) {
      float gv[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {  // the loads first, all in flight
        const int tt = m0 + m * P;
        gv[m] = ok && tt < nt ? lfsr::load(dyc + (size_t)tt * Di) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int tt = m0 + m * P;
        if (tt < nt) {
          s_delta[tt * CG + c] = ok ? delta_from(s_dbc + tt * K, w, bias, R) : 0.f;
          s_dy[tt * CG + c] = gv[m];
        }
      }
    }
  }
  __syncthreads();
  float a2[NS], mu[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    a2[i] = active ? p.A[(size_t)d * N + part * NS + i] * kLog2e : 0.f;
    mu[i] = 0.f;
  }
  float dsum = 0.f;
  for (int tt = nt - 1; tt >= 0; --tt) {  // pass C's ops on mu, from mu = 0
    const float delta = s_delta[tt * CG + cc], g = s_dy[tt * CG + cc];
    const float* crow = s_dbc + tt * K + R + N + part * NS;
#pragma unroll
    for (int i = 0; i < NS; ++i) mu[i] = lfsr::ex2(delta * a2[i]) * fmaf(crow[i], g, mu[i]);
    dsum += delta;
  }
  if (active) {
    const size_t r = (size_t)b * (p.nc - 1) + (p.nc - 1 - k);
#pragma unroll
    for (int i = 0; i < NS; ++i) p.mloc[(r * N + part * NS + i) * Di + d] = mu[i];
    if (part == 0) p.dsum[r * Di + d] = dsum;
  }
}

// Pass C: grid (nc, B), kWarps warps; the CTA walks the channel groups of
// its chunk in turn (see the header)
template <typename T, int N>
__global__ void __launch_bounds__(32 * kWarps, 4) adjoint_kernel(const AdjParams p) {
  constexpr int NP = lfsr::state_span(N);  // lanes a channel spans
  constexpr int CPW = 32 / NP;
  constexpr int CG = kWarps * CPW;      // channels per group
  constexpr int TC = kChunk;
  constexpr bool kAlias = 2 * N <= 32;  // the warp's dB/dC sums fit a spent row of s_h
  constexpr int kPS = kAlias ? 32 : 2 * N;  // their row stride
  constexpr int kPerWarp = TC * 32 + (kAlias ? 0 : TC * kPS);
  constexpr int kAcc = TC * N / (32 * kWarps);     // dB (and dC) values per thread
  constexpr int kItems = TC * CG / (32 * kWarps);  // a group's (step, channel) per thread
  extern __shared__ __align__(16) float smem[];
  const int R = p.R, K = R + 2 * N, L = p.L, Di = p.Di;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // [TC][CG]: the group's (delta, u, dy, delta u), one 16-byte read a step
  float4* s_pre = reinterpret_cast<float4*>(smem);
  // [TC][N]: (B, C) of each step, one 8-byte read
  float2* s_bc = reinterpret_cast<float2*>(s_pre + TC * CG);
  float* s_dtr = reinterpret_cast<float*>(s_bc + TC * N);  // [TC][R]: dt_low_rank
  float* s_warps = s_dtr + TC * R;                          // kWarps x kPerWarp
  float* s_h = s_warps + warp * kPerWarp;       // [TC][32]: h_t of every lane
  float* s_p = kAlias ? s_h : s_h + TC * 32;    // [TC][kPS]: the warp's dB at [0, N), dC at [N, 2N)

  const int n = lane % NP;
  const int cl = lane / NP;
  const bool live = n < N;         // false on the padding lanes (N 24)
  const int ci = warp * CPW + cl;  // the lane's channel in its group
  const int k = blockIdx.x, b = blockIdx.y;
  const int t0 = k * TC, nt = min(TC, L - t0);
  const size_t row0 = (size_t)b * L + t0;  // the chunk's first (b, t) row
  const T* ub = static_cast<const T*>(p.u) + row0 * Di;
  const T* dyb = static_cast<const T*>(p.dy) + row0 * Di;
  float* dub = p.du + row0 * Di;
  float* ddtb = p.ddt + row0 * Di;
  const size_t NDi = (size_t)N * Di;
  const float* st = p.states + ((size_t)b * p.nc + k) * NDi;
  // the carry from chunk k + 1: pass B left mu_in of chunk k at r = nc - 2 - k
  const float* mu_in =
      k + 1 < p.nc ? p.mloc + ((size_t)b * (p.nc - 1) + (p.nc - 2 - k)) * NDi : nullptr;
  float* dab = p.dA + ((size_t)b * p.nc + k) * NDi;

  // A group's delta, u and dy: a thread's kItems (step, channel) items,
  // u and dy loaded (fetch) before the previous group's walks and staged
  // (stage) after them, so the loads are in flight through the walks.
  const int groups = (Di + CG - 1) / CG;
  float ru[kItems], rg[kItems];
  auto fetch = [&](int gi) {
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int i = threadIdx.x + m * 32 * kWarps;
      const int tt = i / CG, dd = gi * CG + i % CG;
      const bool ok = gi < groups && i < nt * CG && dd < Di;
      ru[m] = ok ? lfsr::load(ub + (size_t)tt * Di + dd) : 0.f;
      rg[m] = ok ? lfsr::load(dyb + (size_t)tt * Di + dd) : 0.f;
    }
  };
  auto stage = [&](int gi) {  // 0 on channels past Di: no contribution
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int i = threadIdx.x + m * 32 * kWarps;
      const int tt = i / CG, dd = gi * CG + i % CG;
      if (i < nt * CG) {
        const float delta = dd < Di ? delta_of(s_dtr + tt * R, p.wdt, p.bdt, dd, R, Di) : 0.f;
        s_pre[i] = make_float4(delta, ru[m], rg[m], delta * ru[m]);
      }
    }
  };
  fetch(0);
  {  // the chunk's dbc rows: dt_low_rank to s_dtr, (B, C) pairs to s_bc
    const T* rows = static_cast<const T*>(p.dbc) + row0 * K;
    float* bcf = reinterpret_cast<float*>(s_bc);
    for (int i = threadIdx.x; i < nt * K; i += blockDim.x) {
      const int tt = i / K, c = i % K;
      const float v = lfsr::load(rows + i);
      if (c < R) s_dtr[tt * R + c] = v;
      else if (c < R + N) bcf[2 * (tt * N + c - R)] = v;
      else bcf[2 * (tt * N + c - R - N) + 1] = v;
    }
  }
  float acc_b[kAcc], acc_c[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc_b[j] = acc_c[j] = 0.f;
  __syncthreads();
  stage(0);
  __syncthreads();

  for (int gi = 0; gi < groups; ++gi) {
    fetch(gi + 1);
    const int d = gi * CG + ci;
    const bool active = d < Di, on = active && live;
    const float a_n = on ? p.A[(size_t)d * N + n] : 0.f;
    const float a2 = a_n * kLog2e;
    // forward: the chunk's states from its saved start state (K2's ops)
    const float h0 = on ? st[(size_t)n * Di + d] : 0.f;
    float h = h0;
    for (int tg = 0; tg < nt; tg += kG) {
      float e[kG], bx[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int tt = min(tg + j, nt - 1);  // a ragged tail repeats the last step unused
        const float4 pr = s_pre[tt * CG + ci];
        e[j] = lfsr::ex2(pr.x * a2);
        bx[j] = live ? s_bc[tt * N + n].x * pr.w : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        if (tg + j < nt) {
          h = fmaf(e[j], h, bx[j]);
          s_h[(tg + j) * 32 + lane] = h;
        }
      }
    }
    __syncwarp();
    // backward: the adjoint from the chunk's end to its start, kG steps at a
    // time (steps te, te - 1, ..., te - kG + 1; those below 0 unused)
    float mu = on && mu_in ? mu_in[(size_t)n * Di + d] : 0.f;
    float da_acc = 0.f;
    for (int te = nt - 1; te >= 0; te -= kG) {
      float4 pr[kG];
      float2 bc[kG];
      float dA[kG], hr[kG + 1], lam[kG];  // hr[j]: h after step te - j
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int tt = max(te - j, 0);
        pr[j] = s_pre[tt * CG + ci];
        bc[j] = live ? s_bc[tt * N + n] : make_float2(0.f, 0.f);
        dA[j] = lfsr::ex2(pr[j].x * a2);
        hr[j] = s_h[tt * 32 + lane];
      }
      hr[kG] = te >= kG ? s_h[(te - kG) * 32 + lane] : h0;
#pragma unroll
      for (int j = 0; j < kG; ++j) {  // the carried chain
        lam[j] = fmaf(bc[j].y, pr[j].z, mu);
        if (te - j >= 0) mu = dA[j] * lam[j];
      }
      // Two sums share each butterfly: at its first level a lane keeps one
      // (s1 = sum_n lambda B below NP / 2, wa = sum_n w A above; pb = dB's
      // below lane 16, pc = dC's above) and sends its partner the other
      float v[kG], q[kG], qc[kG];  // qc: dC's sums when a warp holds one channel
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const float hprev = te - j >= 1 ? hr[j + 1] : h0;
        const float w = lam[j] * dA[j] * hprev;
        if (te - j >= 0) da_acc = fmaf(w, pr[j].x, da_acc);
        const float s1 = lam[j] * bc[j].x, wa = w * a_n;
        const float pb = lam[j] * pr[j].w, pc = hr[j] * pr[j].z;
        const bool hi = n & (NP / 2);
        v[j] = (hi ? wa : s1) + __shfl_xor_sync(0xffffffffu, hi ? s1 : wa, NP / 2);
        if constexpr (CPW > 1) {
          q[j] = (lane & 16 ? pc : pb) + __shfl_xor_sync(0xffffffffu, lane & 16 ? pb : pc, 16);
        } else {  // one channel a warp: nothing to sum over channels
          q[j] = pb;
          qc[j] = pc;
        }
      }
#pragma unroll
      for (int o = NP / 4; o > 0; o >>= 1) {  // over the NP lanes of a channel
#pragma unroll
        for (int j = 0; j < kG; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
      }
#pragma unroll
      for (int o = 8; o >= NP; o >>= 1) {  // over the warp's channels
#pragma unroll
        for (int j = 0; j < kG; ++j) q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
      }
      float wa_at0[kG];  // lane n = 0 holds s1; wa from lane NP / 2
#pragma unroll
      for (int j = 0; j < kG; ++j) wa_at0[j] = __shfl_xor_sync(0xffffffffu, v[j], NP / 2);
      __syncwarp();  // every lane has read these steps' rows of s_h
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int tt = te - j;
        if (tt >= 0) {
          if (n == 0 && active) {
            dub[(size_t)tt * Di + d] = v[j] * pr[j].x;
            ddtb[(size_t)tt * Di + d] = fmaf(v[j], pr[j].y, wa_at0[j]);
          }
          if constexpr (CPW > 1) {
            if (lane % 16 < N) s_p[tt * kPS + (lane & 16 ? N : 0) + n] = q[j];
          } else if (live) {
            s_p[tt * kPS + n] = q[j];
            s_p[tt * kPS + N + n] = qc[j];
          }
        }
      }
    }
    if (on) dab[(size_t)n * Di + d] = da_acc;
    __syncthreads();
    // this group's dB / dC: its warps' sums added in warp order; then the
    // next group's delta, u and dy, whose loads have landed
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = threadIdx.x + j * 32 * kWarps;
      if (i < nt * N) {
        const int at = (i / N) * kPS + i % N;
#pragma unroll
        for (int w2 = 0; w2 < kWarps; ++w2) {
          const float* sp = s_warps + w2 * kPerWarp + (kAlias ? 0 : TC * 32);
          acc_b[j] += sp[at];
          acc_c[j] += sp[at + N];
        }
      }
    }
    if (gi + 1 < groups) stage(gi + 1);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = threadIdx.x + j * 32 * kWarps;
    if (i < nt * N) {
      p.dB[row0 * N + i] = acc_b[j];
      p.dC[row0 * N + i] = acc_c[j];
    }
  }
}

// Pass D: out[b, i] = sum over x of part[b, x, i], x in order (i < inner)
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int parts, long long inner, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / inner, r = i % inner;
  const float* q = part + b * parts * inner + r;
  float s = 0.f;
#pragma unroll 8
  for (int x = 0; x < parts; ++x) s += q[x * inner];
  out[i] = s;
}

template <typename T, int N>
cudaError_t launch_summaries(const AdjParams& p, int B, cudaStream_t s) {
  constexpr int P = lfsr::scan_lanes(N);
  const int cg = min(p.Di, min(kMaxThreads / P, kMaxChannels));
  const size_t smem = sizeof(float) * ((size_t)kChunk * (p.R + 2 * N) + 2 * (size_t)kChunk * cg);
  auto* kernel = adjoint_summary_kernel<T, N>;
  cudaError_t e = lfsr::set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((p.Di + cg - 1) / cg, p.nc - 1, B), cg * P, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_adjoint(const AdjParams& p, int B, cudaStream_t s) {
  constexpr int CG = kWarps * (32 / lfsr::state_span(N));
  const size_t per_warp = kChunk * 32 + (2 * N <= 32 ? 0 : kChunk * 2 * N);
  const size_t smem = sizeof(float) * ((size_t)kChunk * (4 * CG + 2 * N + p.R) +
                                       kWarps * per_warp);
  auto* kernel = adjoint_kernel<T, N>;
  cudaError_t e = lfsr::set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.nc, B), 32 * kWarps, smem, s>>>(p);
  return cudaGetLastError();
}

// pass: 'A' summaries, 'C' the adjoint
template <typename T, int N>
cudaError_t run_pass(const AdjParams& p, int B, char pass, cudaStream_t s) {
  return pass == 'A' ? launch_summaries<T, N>(p, B, s) : launch_adjoint<T, N>(p, B, s);
}

template <typename T>
cudaError_t by_state(const AdjParams& p, int B, int N, char pass, cudaStream_t s) {
  switch (N) {
    case 4: return run_pass<T, 4>(p, B, pass, s);
    case 8: return run_pass<T, 8>(p, B, pass, s);
    case 16: return run_pass<T, 16>(p, B, pass, s);
    case 24: return run_pass<T, 24>(p, B, pass, s);
    case 32: return run_pass<T, 32>(p, B, pass, s);
    default: return cudaErrorInvalidValue;
  }
}

int pass_entry(AdjParams& p, int B, int N, int spacing, int dtype, char pass, void* stream) {
  if (p.R < 1 || p.R > kMaxR || B < 1 || B > 65535 || p.L < 1 || p.Di < 1 ||
      spacing != kChunk)
    return cudaErrorInvalidValue;
  p.nc = (p.L + kChunk - 1) / kChunk;
  if ((pass == 'A' && (p.nc == 1 || p.nc > 65536 || !p.mloc || !p.dsum)) ||
      (pass == 'C' && p.nc > 1 && !p.mloc))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return by_state<float>(p, B, N, pass, s);
  if (dtype == lfsr::kBF16) return by_state<__nv_bfloat16>(p, B, N, pass, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Pass A: mloc [B, nc - 1, N, Di] and dsum [B, nc - 1, Di] float32 scratch
// (nc = ceil(L / spacing) > 1), chunk k's at r = nc - 1 - k. dbc and dy
// contiguous, of ``dtype``; spacing must be 64.
LFSR_EXPORT int lfsr_scan_adjoint_summaries(const void* dbc, const void* dy, const void* wdt,
                                            const void* bdt, const void* A, void* mloc,
                                            void* dsum, int B, int L, int Di, int R, int N,
                                            int spacing, int dtype, void* stream) {
  AdjParams p{};
  p.dbc = dbc; p.dy = dy;
  p.wdt = static_cast<const float*>(wdt); p.bdt = static_cast<const float*>(bdt);
  p.A = static_cast<const float*>(A);
  p.mloc = static_cast<float*>(mloc); p.dsum = static_cast<float*>(dsum);
  p.L = L; p.Di = Di; p.R = R;
  return pass_entry(p, B, N, spacing, dtype, 'A', stream);
}

// Pass C: du, ddt [B, L, Di], dB, dC [B, L, N] and dA_chunks [B, nc, N, Di]
// float32 (dA itself when nc = 1); states [B, nc, N, Di] from K2 at the same
// spacing (64); mloc as after pass B (unused, and may be null, when nc = 1).
// u, dbc and dy contiguous, of ``dtype``.
LFSR_EXPORT int lfsr_scan_adjoint(const void* u, const void* dbc, const void* dy,
                                  const void* wdt, const void* bdt, const void* A,
                                  const void* states, const void* mloc, void* du, void* ddt,
                                  void* dB, void* dC, void* dA_chunks, int B, int L, int Di,
                                  int R, int N, int spacing, int dtype, void* stream) {
  AdjParams p{};
  p.u = u; p.dbc = dbc; p.dy = dy;
  p.wdt = static_cast<const float*>(wdt); p.bdt = static_cast<const float*>(bdt);
  p.A = static_cast<const float*>(A); p.states = static_cast<const float*>(states);
  p.mloc = const_cast<float*>(static_cast<const float*>(mloc));
  p.du = static_cast<float*>(du); p.ddt = static_cast<float*>(ddt);
  p.dB = static_cast<float*>(dB); p.dC = static_cast<float*>(dC);
  p.dA = static_cast<float*>(dA_chunks);
  p.L = L; p.Di = Di; p.R = R;
  return pass_entry(p, B, N, spacing, dtype, 'C', stream);
}

// Pass D: out[b, i] = sum_x part[b, x, i] over x = 0 .. parts - 1 in order,
// i < inner; float32
LFSR_EXPORT int lfsr_sum_parts(const void* part, void* out, int B, int parts, int inner,
                               void* stream) {
  if (B < 1 || parts < 1 || inner < 1) return cudaErrorInvalidValue;
  const long long total = (long long)B * inner;
  const int threads = 256;
  sum_parts_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), parts, inner, total);
  return cudaGetLastError();
}
