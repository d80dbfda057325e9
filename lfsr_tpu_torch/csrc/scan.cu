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
// The scans of K9b (::_scan_gated_kernel) and K9c (::_mamba_inner_kernel)
// are the same kernel with the gate epilogue (template flag kGate, entry
// lfsr_scan_gate): y_t[d] = (sum_n C_t[n] h_t[n] + D[d] u_t[d]) silu(z_t[d]),
// stored in z's dtype. K9c takes delta from dbc as K1 does; K9b takes delta
// as an array, before softplus or after it, and B and C as arrays. B, C and
// z are read at a row stride, so B and C come straight out of dbc and z out
// of in_proj's output, without copies. The rest of K9b and K9c
// (the out-projection, the conv + x_proj front) is in mamba_inner.cu.
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
//  - The forward scan walks kGroup = 8 steps at a time: their exp and
//    shared-memory reads first, then the 8 dependent h updates, then 8
//    interleaved shuffle butterflies, so a lone warp waits on one chain of
//    latencies per 8 steps instead of per step. Each step's arithmetic is
//    unchanged, so y is the same bit for bit as one step at a time. The
//    tile's staging and pre-pass, not overlapped with the recurrence, are
//    what is left (PERF.md).
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

constexpr int kTile = 128;      // time steps staged per tile (the forward scan)
constexpr int kMaxR = 8;        // dt rank limit: ceil(C/16) <= 8 for C <= 128
constexpr int kGroup = 8;       // forward scan: time steps whose butterflies interleave
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

// Where the forward scan takes delta from (ScanParams::mode):
//  kFromDbc   K1/K2/K9c: softplus(dbc[:R] . Wdt + bdt), B and C from the same dbc row
//  kGivenRaw  K9b with pre_softplus: softplus(delta), B and C from their own arrays
//  kGiven     K9b: delta as given
enum DeltaMode : int { kFromDbc = 0, kGivenRaw = 1, kGiven = 2 };

// Operands of the forward scan. u, dbc, delta and y are contiguous; B, C
// and z are read at a row stride (elements between time steps; the batch
// stride is L rows), so B and C come straight out of dbc and z out of
// in_proj's [x | z] output.
struct ScanParams {
  const void* u;                        // [B, L, Di] (TU)
  const void* dbc;                      // kFromDbc: [B, L, R + 2N] rows [dt_low_rank | B | C] (TU)
  const void* delta;                    // kGiven*: [B, L, Di] (TU)
  const void* bm; long long sbm;        // kGiven*: B [B, L, N] (TU)
  const void* cm; long long scm;        // kGiven*: C [B, L, N] (TU)
  const void* z; long long sz;          // kGate: the gate's input [B, L, Di] (TY)
  void* y;                              // [B, L, Di] (TY)
  const float* wdt; const float* bdt;   // kFromDbc: [R, Di], [Di]
  const float* A; const float* dskip;   // [Di, N], [Di]
  float* states;                        // kStates: [B, ceil(L / spacing), N, Di]
  int L, Di, R, spacing, mode;
};

// The forward scan: K1, K2 (kStates) and the scan of K9b/K9c (kGate, whose
// epilogue multiplies y + u D by silu(z) before the store). u, dbc, delta, B
// and C are TU; z and y are TY (K1/K2: TY == TU). One warp walks all L
// steps and issues in order, so what bounds it is the latency of each
// step's dependent chain (shared-memory read, exp, the log2(N) shuffles of
// the sum over n); interleaving kGroup steps overlaps kGroup such chains.
template <typename TU, typename TY, int N, bool kStates, bool kGate>
__global__ void __launch_bounds__(32) scan_kernel(const ScanParams p) {
  constexpr int CPW = 32 / N;  // channels per warp
  constexpr int kCols = (2 * N + 31) / 32;             // staged B|C columns per lane
  constexpr int kRowsPerPass = 32 * kCols / (2 * N);  // B|C rows per warp pass
  extern __shared__ float smem[];
  const bool from_dbc = p.mode == kFromDbc;
  const int K = from_dbc ? p.R + 2 * N : 2 * N;  // floats staged per time step
  const int ob = from_dbc ? p.R : 0;             // B's offset in a staged row; C follows
  float* s_row = smem;                  // [kTile][K]
  float* s_delta = s_row + kTile * K;   // [kTile][CPW]
  float* s_du = s_delta + kTile * CPW;  // [kTile][CPW]
  float* s_u = s_du + kTile * CPW;      // [kTile][CPW]
  float* s_g = s_u + kTile * CPW;       // [kTile][CPW], kGate: silu(z)

  const int lane = threadIdx.x;
  const int n = lane % N;
  const int cl = lane / N;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPW;
  const int d = d0 + cl;
  const int L = p.L, Di = p.Di;
  const bool active = d < Di;

  const float a_n = active ? p.A[(size_t)d * N + n] : 0.f;
  const float d_skip = active ? p.dskip[d] : 0.f;
  float h = 0.f;

  const size_t bl = (size_t)b * L;  // the batch row's first time step
  const TU* ub = static_cast<const TU*>(p.u) + bl * Di;
  TY* yb = static_cast<TY*>(p.y) + bl * Di;
  float* sb = nullptr;
  if constexpr (kStates) sb = p.states + (size_t)b * ((L + p.spacing - 1) / p.spacing) * N * Di;
  int until = 0;  // K2: steps until the next block start

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nt = min(kTile, L - t0);
    __syncwarp();
    if (from_dbc) {
      const TU* rows = static_cast<const TU*>(p.dbc) + (bl + t0) * K;
      for (int i = lane; i < nt * K; i += 32) s_row[i] = lfsr::load(rows + i);
    } else {  // B to s_row[t][0, N), C to s_row[t][N, 2N)
      // Each lane owns fixed columns, with one base pointer and stride each:
      // index arithmetic per element (a divide, a select) in this loop kept
      // its loads from overlapping (PERF.md, section 6).
      const TU* bt = static_cast<const TU*>(p.bm) + (bl + t0) * p.sbm;
      const TU* ct = static_cast<const TU*>(p.cm) + (bl + t0) * p.scm;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = (lane + 32 * c) % (2 * N);
        const TU* src = col < N ? bt + col : ct + (col - N);
        const long long sr = col < N ? p.sbm : p.scm;
        for (int t = (lane + 32 * c) / (2 * N); t < nt; t += kRowsPerPass)
          s_row[t * 2 * N + col] = lfsr::load(src + (size_t)t * sr);
      }
    }
    __syncwarp();
    // pre-pass: delta, delta*u, u (and silu(z)) for every (t, channel) of the
    // tile. An element's global loads are all issued before any of them is
    // used, so their latencies overlap instead of adding up.
    for (int i = lane; i < nt * CPW; i += 32) {
      const int tt = i / CPW;
      const int dd = d0 + i % CPW;
      float delta = 0.f, uu = 0.f, g = 0.f;
      if (dd < Di) {
        const size_t at = (size_t)(t0 + tt) * Di + dd;
        uu = lfsr::load(ub + at);
        const float raw =
            from_dbc ? 0.f : lfsr::load(static_cast<const TU*>(p.delta) + bl * Di + at);
        float zz = 0.f;
        if constexpr (kGate)
          zz = lfsr::load(static_cast<const TY*>(p.z) + (bl + t0 + tt) * p.sz + dd);
        if (from_dbc) delta = delta_of(s_row + tt * K, p.wdt, p.bdt, dd, p.R, Di);
        else delta = p.mode == kGivenRaw ? softplus(raw) : raw;
        if constexpr (kGate) g = zz / (1.f + expf(-zz));
      }
      s_delta[i] = delta;
      s_du[i] = delta * uu;
      s_u[i] = uu;
      if constexpr (kGate) s_g[i] = g;
    }
    __syncwarp();
    // the recurrence, kGroup steps at a time: their exp and shared-memory
    // reads first, then the h chain, then kGroup interleaved butterflies
    // over the N states (each step's arithmetic in the order of one step at
    // a time, so the result does not depend on kGroup)
    for (int tg = 0; tg < nt; tg += kGroup) {
      float e[kGroup], bx[kGroup], c[kGroup], part[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int tt = min(tg + k, nt - 1);  // a ragged tail repeats the last step unused
        const float* row = s_row + tt * K;
        const int ti = tt * CPW + cl;
        e[k] = expf(s_delta[ti] * a_n);
        bx[k] = row[ob + n] * s_du[ti];
        c[k] = row[ob + N + n];
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (tg + k < nt) {
          if constexpr (kStates) {
            if (until == 0) {  // the state before step t0 + tg + k starts a block
              if (active) sb[((size_t)((t0 + tg + k) / p.spacing) * N + n) * Di + d] = h;
              until = p.spacing;
            }
            --until;
          }
          h = fmaf(e[k], h, bx[k]);
        }
        part[k] = c[k] * h;
      }
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) part[k] += __shfl_xor_sync(0xffffffffu, part[k], o);
      }
      if (n == 0 && active) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (tg + k >= nt) break;
          const int ti = (tg + k) * CPW + cl;
          float v = fmaf(s_u[ti], d_skip, part[k]);
          if constexpr (kGate) v *= s_g[ti];
          lfsr::store(yb + (size_t)(t0 + tg + k) * Di + d, v);
        }
      }
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

template <typename TU, typename TY, int N, bool kStates, bool kGate>
cudaError_t launch_scan(const ScanParams& p, int B, cudaStream_t stream) {
  constexpr int CPW = 32 / N;
  const int K = p.mode == kFromDbc ? p.R + 2 * N : 2 * N;
  const size_t smem = sizeof(float) * (size_t)kTile * (K + (kGate ? 4 : 3) * CPW);
  cudaError_t e = lfsr::set_smem((const void*)scan_kernel<TU, TY, N, kStates, kGate>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Di + CPW - 1) / CPW, B);
  scan_kernel<TU, TY, N, kStates, kGate><<<grid, 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TU, typename TY, bool kStates, bool kGate>
cudaError_t dispatch_n(const ScanParams& p, int B, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch_scan<TU, TY, 4, kStates, kGate>(p, B, s);
    case 8: return launch_scan<TU, TY, 8, kStates, kGate>(p, B, s);
    case 16: return launch_scan<TU, TY, 16, kStates, kGate>(p, B, s);
    case 32: return launch_scan<TU, TY, 32, kStates, kGate>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// K1 / K2: contiguous u, dbc and y of one dtype, delta from dbc
template <bool kStates>
cudaError_t scan_entry(const void* u, const void* dbc, const void* wdt, const void* bdt,
                       const void* A, const void* dskip, void* y, void* states, int B, int L,
                       int Di, int R, int N, int spacing, int dtype, void* stream) {
  if (R < 1 || R > kMaxR || B < 1 || L < 1 || Di < 1 || spacing < 1)
    return cudaErrorInvalidValue;
  ScanParams p{};
  p.u = u; p.dbc = dbc; p.y = y;
  p.wdt = static_cast<const float*>(wdt); p.bdt = static_cast<const float*>(bdt);
  p.A = static_cast<const float*>(A); p.dskip = static_cast<const float*>(dskip);
  p.states = static_cast<float*>(states);
  p.L = L; p.Di = Di; p.R = R; p.spacing = spacing; p.mode = kFromDbc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return dispatch_n<float, float, kStates, false>(p, B, N, s);
  if (dtype == lfsr::kBF16)
    return dispatch_n<__nv_bfloat16, __nv_bfloat16, kStates, false>(p, B, N, s);
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
  cudaError_t e = lfsr::set_smem((const void*)scan_proj_bwd_kernel<T, N>, smem);
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

// The scan of K9b and K9c: y = (scan + u D) * silu(z). mode kFromDbc (K9c)
// takes delta, B and C from dbc rows as K1 does (wdt, bdt, R read); kGivenRaw
// and kGiven (K9b) take delta, B and C as arrays. u, dbc, delta and y are
// contiguous; B, C and z are read at row strides (elements). u_dtype is that
// of u, dbc, delta, B and C; g_dtype that of z and y: both float32, both
// bfloat16 (K9b, K9c), or float32 u with bfloat16 z and y (K9c).
LFSR_EXPORT int lfsr_scan_gate(const void* u, const void* dbc, const void* delta, const void* bm,
                               long long sbm, const void* cm, long long scm, const void* z,
                               long long sz, void* y, const void* wdt, const void* bdt,
                               const void* A, const void* dskip, int B, int L, int Di, int R,
                               int N, int mode, int u_dtype, int g_dtype, void* stream) {
  if (B < 1 || L < 1 || Di < 1 || mode < kFromDbc || mode > kGiven ||
      (mode == kFromDbc && (R < 1 || R > kMaxR)))
    return cudaErrorInvalidValue;
  ScanParams p{};
  p.u = u; p.dbc = dbc; p.delta = delta; p.bm = bm; p.sbm = sbm; p.cm = cm; p.scm = scm;
  p.z = z; p.sz = sz; p.y = y;
  p.wdt = static_cast<const float*>(wdt); p.bdt = static_cast<const float*>(bdt);
  p.A = static_cast<const float*>(A); p.dskip = static_cast<const float*>(dskip);
  p.L = L; p.Di = Di; p.R = R; p.spacing = 1; p.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (u_dtype == lfsr::kF32 && g_dtype == lfsr::kF32)
    return dispatch_n<float, float, false, true>(p, B, N, s);
  if (u_dtype == lfsr::kF32 && g_dtype == lfsr::kBF16)
    return dispatch_n<float, bf16, false, true>(p, B, N, s);
  if (u_dtype == lfsr::kBF16 && g_dtype == lfsr::kBF16)
    return dispatch_n<bf16, bf16, false, true>(p, B, N, s);
  return cudaErrorInvalidValue;
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
