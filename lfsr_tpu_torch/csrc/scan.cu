// K9a / K9b / K9c's selective scan, walked one recurrence per warp.
//
// The selective scan, for every (batch b, channel d):
//   h_t[n]  = exp(delta_t A[d, n]) h_{t-1}[n] + B_t[n] delta_t u_t[d]
//   y_t[d]  = sum_n C_t[n] h_t[n] + D[d] u_t[d]
// K1 and K2 (lfsr_tpu/ops/pallas_scan.py::_scan_proj_kernel and
// ::_scan_proj_states_kernel, delta = softplus(dbc[t, :R] . Wdt[:, d] +
// bdt[d]) from dbc = [dt_low_rank | B | C], the raw x_proj output) are the
// chunk-parallel scan of csrc/scan_chunked.cu, and K3, their adjoint, the
// chunk-parallel reverse scan of csrc/scan_adjoint.cu; this file's forward
// scan was K1/K2's until then and is, for now, that of K9a-K9c.
//
// The scans of K9b (::_scan_gated_kernel) and K9c (::_mamba_inner_kernel)
// are this kernel with the gate epilogue (template epilogue kEpiGate,
// entry lfsr_scan_gate): y_t[d] = (sum_n C_t[n] h_t[n] + D[d] u_t[d]) silu(z_t[d]),
// stored in z's dtype. K9c takes delta from dbc as K1 does; K9b takes delta
// as an array, before softplus or after it, and B and C as arrays. B, C and
// z are read at a row stride, so B and C come straight out of dbc and z out
// of in_proj's output, without copies. The rest of K9b and K9c
// (the out-projection, the conv + x_proj front) is in mamba_inner.cu.
//
// K9a replaces ::_scan_chunk_kernel and ::_scan_chunk_kernel_flat (one
// function in two TPU lane layouts, behind selective_scan_fused): the same
// kernel with delta, B and C given as K9b takes them, and the epilogue
// kEpiRound (entry lfsr_scan_given): y_t[d] = round(sum_n C_t[n] h_t[n]) in
// u's dtype, then + D[d] u_t[d] and rounded again, the two roundings of
// JAX's y.astype(u.dtype) before its D skip.
//
// What bounds them on this card: the recurrence is sequential in t. At the
// training point (B=8, Di=80, N=16, L=25600) there are 8*80*16 = 10240
// scalar recurrences, a few warps per SM, so every kernel here is
// latency-bound (one dependent step after another), not bandwidth-bound;
// csrc/scan_chunked.cu is the cure, still to be applied to these.
//
// Design: the TPU kernel carries the state across a sequential grid axis;
// Hopper's blocks run in no order, so a warp owns whole (b, d) recurrences
// and loops over L itself.
//  - Lane = (channel-in-warp, state n): 32/NP channels per warp, the N states
//    of a channel on NP = lfsr::state_span(N) lanes (N, or 32 at N 24, where
//    lanes n >= 24 hold h = 0 and add 0), each lane holding its h[n] in a
//    register. The sum over n is a shuffle butterfly over those NP lanes.
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
// All arithmetic is float32; u, dbc, delta, z and y are float32 or bfloat16.
#include "common.cuh"

namespace {

constexpr int kTile = 128;      // time steps staged per tile (the forward scan)
constexpr int kMaxR = 8;        // dt rank limit: ceil(C/16) <= 8 for C <= 128
constexpr int kGroup = 8;       // forward scan: time steps whose butterflies interleave

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// delta for channel dd from a staged dbc row (the op order of K1, K2, K3 and K9c)
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
//  kFromDbc   K9c: softplus(dbc[:R] . Wdt + bdt), B and C from the same dbc row
//  kGivenRaw  K9b with pre_softplus: softplus(delta), B and C from their own arrays
//  kGiven     K9b: delta as given
enum DeltaMode : int { kFromDbc = 0, kGivenRaw = 1, kGiven = 2 };

// What the forward scan stores for y_t[d], with s = sum_n C_t[n] h_t[n]:
//  kEpiGate   K9b/K9c: (s + D u) silu(z)
//  kEpiRound  K9a: round(round(s) + D u) in TY (D u left out without D)
// A template parameter: each instance compiles its own epilogue only.
enum Epilogue : int { kEpiGate = 1, kEpiRound = 2 };

// x rounded to T's precision (identity for float32)
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
  const void* z; long long sz;          // kEpiGate: the gate's input [B, L, Di] (TY)
  void* y;                              // [B, L, Di] (TY)
  const float* wdt; const float* bdt;   // kFromDbc: [R, Di], [Di]
  const float* A; const float* dskip;   // [Di, N], [Di] (kEpiRound: may be null)
  int L, Di, R, mode;
};

// The forward scan: the scan of K9b/K9c (kEpiGate, whose epilogue
// multiplies y + u D by silu(z) before the store) and K9a (kEpiRound). u,
// dbc, delta, B and C are TU; z and y are TY (K9a: TY == TU). One warp walks all L
// steps and issues in order, so what bounds it is the latency of each
// step's dependent chain (shared-memory read, exp, the log2(N) shuffles of
// the sum over n); interleaving kGroup steps overlaps kGroup such chains.
template <typename TU, typename TY, int N, int kEpi>
__global__ void __launch_bounds__(32) scan_kernel(const ScanParams p) {
  constexpr bool kGate = kEpi == kEpiGate;
  constexpr int NP = lfsr::state_span(N);  // lanes a channel spans
  constexpr int CPW = 32 / NP;             // channels per warp
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
  float* s_g = s_u + kTile * CPW;       // [kTile][CPW], kEpiGate: silu(z)

  const int lane = threadIdx.x;
  const int n = lane % NP;
  const int cl = lane / NP;
  const bool live = n < N;  // false on the padding lanes (N 24)
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPW;
  const int d = d0 + cl;
  const int L = p.L, Di = p.Di;
  const bool active = d < Di;

  const float a_n = active && live ? p.A[(size_t)d * N + n] : 0.f;
  const float d_skip = active && (kEpi != kEpiRound || p.dskip) ? p.dskip[d] : 0.f;
  float h = 0.f;

  const size_t bl = (size_t)b * L;  // the batch row's first time step
  const TU* ub = static_cast<const TU*>(p.u) + bl * Di;
  TY* yb = static_cast<TY*>(p.y) + bl * Di;

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
        // the slots past the whole rows a pass covers idle (N 24: 48 of 64)
        if (lane + 32 * c >= kRowsPerPass * 2 * N) break;
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
        bx[k] = live ? row[ob + n] * s_du[ti] : 0.f;
        c[k] = live ? row[ob + N + n] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (tg + k < nt) h = fmaf(e[k], h, bx[k]);
        part[k] = c[k] * h;
      }
#pragma unroll
      for (int o = NP / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) part[k] += __shfl_xor_sync(0xffffffffu, part[k], o);
      }
      if (n == 0 && active) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (tg + k >= nt) break;
          const int ti = (tg + k) * CPW + cl;
          float v;
          if constexpr (kEpi == kEpiRound) {
            v = round_to(part[k], yb);
            if (p.dskip) v = fmaf(s_u[ti], d_skip, v);
          } else {
            v = fmaf(s_u[ti], d_skip, part[k]);
            if constexpr (kGate) v *= s_g[ti];
          }
          lfsr::store(yb + (size_t)(t0 + tg + k) * Di + d, v);
        }
      }
    }
  }
}

template <typename TU, typename TY, int N, int kEpi>
cudaError_t launch_scan(const ScanParams& p, int B, cudaStream_t stream) {
  constexpr int CPW = 32 / lfsr::state_span(N);
  const int K = p.mode == kFromDbc ? p.R + 2 * N : 2 * N;
  const size_t smem =
      sizeof(float) * (size_t)kTile * (K + (kEpi == kEpiGate ? 4 : 3) * CPW);
  cudaError_t e = lfsr::set_smem((const void*)scan_kernel<TU, TY, N, kEpi>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Di + CPW - 1) / CPW, B);
  scan_kernel<TU, TY, N, kEpi><<<grid, 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TU, typename TY, int kEpi>
cudaError_t dispatch_n(const ScanParams& p, int B, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch_scan<TU, TY, 4, kEpi>(p, B, s);
    case 8: return launch_scan<TU, TY, 8, kEpi>(p, B, s);
    case 16: return launch_scan<TU, TY, 16, kEpi>(p, B, s);
    case 24: return launch_scan<TU, TY, 24, kEpi>(p, B, s);
    case 32: return launch_scan<TU, TY, 32, kEpi>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  p.L = L; p.Di = Di; p.R = R; p.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (u_dtype == lfsr::kF32 && g_dtype == lfsr::kF32)
    return dispatch_n<float, float, kEpiGate>(p, B, N, s);
  if (u_dtype == lfsr::kF32 && g_dtype == lfsr::kBF16)
    return dispatch_n<float, bf16, kEpiGate>(p, B, N, s);
  if (u_dtype == lfsr::kBF16 && g_dtype == lfsr::kBF16)
    return dispatch_n<bf16, bf16, kEpiGate>(p, B, N, s);
  return cudaErrorInvalidValue;
}

// K9a: y = round(round(scan) + u D) in u's dtype, delta given (kGivenRaw:
// before softplus; kGiven: after it). u, delta and y are contiguous; B and C
// are read at row strides (elements). dskip may be null (no D skip). u,
// delta, B, C and y are all of ``dtype``.
LFSR_EXPORT int lfsr_scan_given(const void* u, const void* delta, const void* bm, long long sbm,
                                const void* cm, long long scm, void* y, const void* A,
                                const void* dskip, int B, int L, int Di, int N, int mode,
                                int dtype, void* stream) {
  if (B < 1 || L < 1 || Di < 1 || (mode != kGivenRaw && mode != kGiven))
    return cudaErrorInvalidValue;
  ScanParams p{};
  p.u = u; p.delta = delta; p.bm = bm; p.sbm = sbm; p.cm = cm; p.scm = scm; p.y = y;
  p.A = static_cast<const float*>(A); p.dskip = static_cast<const float*>(dskip);
  p.L = L; p.Di = Di; p.R = 0; p.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return dispatch_n<float, float, kEpiRound>(p, B, N, s);
  if (dtype == lfsr::kBF16)
    return dispatch_n<__nv_bfloat16, __nv_bfloat16, kEpiRound>(p, B, N, s);
  return cudaErrorInvalidValue;
}

LFSR_EXPORT const char* lfsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
