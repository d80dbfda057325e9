// K9b / K9c — the parts of the gated-epilogue scan and of the fused Mamba
// inner pipeline that are not the scan itself (that is scan.cu's forward
// kernel with the gate epilogue, lfsr_scan_gate).
//
// K9b replaces lfsr_tpu/ops/pallas_scan.py::_scan_gated_kernel:
//   out = ((scan(u, delta, A, B, C) + u D) silu(z)) @ W_out
// as lfsr_scan_gate (the gated y, rounded to the operands' dtype) followed
// by lfsr_rows_matmul here: a row-tiled [rows, K] @ [K, M] product with
// float32 accumulation, written in the same dtype.
// K9c replaces ::_mamba_inner_kernel:
//   xc  = silu(causal depthwise conv1d(xs, width KC) + b)
//   dbc = xc @ Wx                                   [Di -> R + 2N]
//   y   = (scan(xc, softplus(dbc[:R] Wdt + bdt), A, B, C) + xc D) silu(z)
// as lfsr_mamba_front here (xc and dbc, float32) followed by lfsr_scan_gate,
// which takes delta, B and C from dbc as K1 does.
//
// Why split, and not fused as on the TPU. The TPU fuses to save HBM round
// trips. On this card the scan is a latency-bound recurrence: one warp per
// (batch row, 32/N channels) walks all L steps, tens of ms per launch at a
// whole-scene L against a bound of ~0.3 ms (PERF.md). The out-projection
// and x_proj contract over all Di channels, which cross the scan's warps:
// fused into the scan they would put a batch row's Di N / 32 warps on one
// SM. Written
// once and read back, the gated y (K9b) or xc and dbc (K9c) cost about 1 GB
// of traffic at a whole-scene dispatch, ~0.3 ms at 3.35 TB/s.
//
// What bounds the two kernels here: bytes. Both are parallel over rows: a
// block stages a tile of rows and the small weights in shared memory as
// float32, and each thread accumulates its outputs in float32 over the
// contraction in order. The products run on the CUDA cores; tensor-core
// tiles are later work: the scan beside them takes far longer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMatRows = 128;   // rows per block of the product
constexpr int kFrontRows = 64;  // time steps per block of the front

// out[r, m] = sum_k x[r, k] w[k, m] (float32, k in order)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   long long rows, int K, int M) {
  extern __shared__ float smem[];
  float* s_w = smem;         // [K][M]
  float* s_x = s_w + K * M;  // [kMatRows][K]
  const long long r0 = (long long)blockIdx.x * kMatRows;
  const int nr = (int)min((long long)kMatRows, rows - r0);
  for (int i = threadIdx.x; i < K * M; i += kThreads) s_w[i] = lfsr::load(w + i);
  for (int i = threadIdx.x; i < nr * K; i += kThreads)
    s_x[i] = lfsr::load(x + r0 * K + i);
  __syncthreads();
  for (int i = threadIdx.x; i < nr * M; i += kThreads) {
    const int r = i / M, m = i % M;
    const float* xr = s_x + r * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(xr[k], s_w[k * M + m], acc);
    lfsr::store(out + (r0 + r) * M + m, acc);
  }
}

// xc[b, t] = silu(sum_k wconv[k] xs[b, t - KC + 1 + k] + bconv) (xs = 0 before
// t = 0 of each batch row); dbc[b, t] = xc[b, t] @ wx. xs rows at stride sxs.
template <typename TI>
__global__ void __launch_bounds__(kThreads)
mamba_front_kernel(const TI* __restrict__ xs, long long sxs, const float* __restrict__ wconv,
                   const float* __restrict__ bconv, const float* __restrict__ wx,
                   float* __restrict__ xc, float* __restrict__ dbc, int L, int Di, int KC,
                   int J) {
  extern __shared__ float smem[];
  float* s_wx = smem;                               // [Di][J]
  float* s_xe = s_wx + Di * J;                      // [kFrontRows + KC - 1][Di]
  float* s_xc = s_xe + (kFrontRows + KC - 1) * Di;  // [kFrontRows][Di]
  const int t0 = blockIdx.x * kFrontRows;
  const int nr = min(kFrontRows, L - t0);
  const size_t bl = (size_t)blockIdx.y * L;  // the batch row's first time step
  for (int i = threadIdx.x; i < Di * J; i += kThreads) s_wx[i] = wx[i];
  // xs rows t0 - KC + 1 .. t0 + nr - 1, the causal window of the tile
  for (int i = threadIdx.x; i < (nr + KC - 1) * Di; i += kThreads) {
    const int t = t0 - (KC - 1) + i / Di;
    s_xe[i] = t >= 0 ? lfsr::load(xs + (bl + t) * sxs + i % Di) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * Di; i += kThreads) {
    const int r = i / Di, dd = i % Di;
    float acc = 0.f;
    for (int k = 0; k < KC; ++k) acc = fmaf(s_xe[(r + k) * Di + dd], wconv[k * Di + dd], acc);
    acc += bconv[dd];
    const float v = acc / (1.f + expf(-acc));
    s_xc[i] = v;
    xc[(bl + t0) * Di + i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * J; i += kThreads) {
    const int r = i / J, j = i % J;
    const float* xr = s_xc + r * Di;
    float acc = 0.f;
    for (int dd = 0; dd < Di; ++dd) acc = fmaf(xr[dd], s_wx[dd * J + j], acc);
    dbc[(bl + t0) * J + i] = acc;
  }
}

template <typename T>
cudaError_t launch_matmul(const void* x, const void* w, void* out, long long rows, int K,
                          int M, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)kMatRows * K);
  cudaError_t e = lfsr::set_smem((const void*)rows_matmul_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((rows + kMatRows - 1) / kMatRows);
  rows_matmul_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, K, M);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_front(const void* xs, long long sxs, const void* wconv, const void* bconv,
                         const void* wx, void* xc, void* dbc, int B, int L, int Di, int KC,
                         int J, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)Di * J + (size_t)(2 * kFrontRows + KC - 1) * Di);
  cudaError_t e = lfsr::set_smem((const void*)mamba_front_kernel<TI>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + kFrontRows - 1) / kFrontRows, B);
  mamba_front_kernel<TI><<<grid, kThreads, smem, s>>>(
      static_cast<const TI*>(xs), sxs, static_cast<const float*>(wconv),
      static_cast<const float*>(bconv), static_cast<const float*>(wx), static_cast<float*>(xc),
      static_cast<float*>(dbc), L, Di, KC, J);
  return cudaGetLastError();
}

}  // namespace

// K9b's out-projection: out [rows, M] = x [rows, K] @ w [K, M], all of one
// dtype and contiguous, float32 accumulation.
LFSR_EXPORT int lfsr_rows_matmul(const void* x, const void* w, void* out, long long rows,
                                 int K, int M, int dtype, void* stream) {
  if (rows < 1 || K < 1 || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return launch_matmul<float>(x, w, out, rows, K, M, s);
  if (dtype == lfsr::kBF16) return launch_matmul<__nv_bfloat16>(x, w, out, rows, K, M, s);
  return cudaErrorInvalidValue;
}

// K9c's front: xc [B, L, Di] and dbc [B, L, J] (float32, contiguous) from xs
// [B, L, Di] (dtype, rows at stride sxs), wconv [KC, Di], bconv [Di], wx [Di, J].
LFSR_EXPORT int lfsr_mamba_front(const void* xs, long long sxs, const void* wconv,
                                 const void* bconv, const void* wx, void* xc, void* dbc, int B,
                                 int L, int Di, int KC, int J, int dtype, void* stream) {
  if (B < 1 || L < 1 || Di < 1 || KC < 1 || J < 1 || sxs < Di) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return launch_front<float>(xs, sxs, wconv, bconv, wx, xc, dbc, B, L, Di, KC, J, s);
  if (dtype == lfsr::kBF16)
    return launch_front<__nv_bfloat16>(xs, sxs, wconv, bconv, wx, xc, dbc, B, L, Di, KC, J, s);
  return cudaErrorInvalidValue;
}
