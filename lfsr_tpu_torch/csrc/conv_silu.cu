// K14 — the Mamba's causal depthwise conv1d over L, its bias and SiLU, as one
// kernel.
//
// Replaces no TPU kernel: JAX runs Mamba._conv_silu (lfsr_tpu/models/ssm.py)
// as XLA elementwise ops. In PyTorch it was conv_silu's chain (ops/scan.py, the
// plain twin): a pad, K products, K - 1 adds, the bias add and F.silu, ~13
// launches and ~8 GB of traffic a whole-scene call ([4, 518400, 80] bf16).
//
// For xs [B, L, Di] of T (float32 or bf16), its rows spaced by a row stride
// sx (the first half of in_proj's output xz: sx = 2 Di), wconv [K, Di] at
// any strides and bconv [Di] (float32, rounded to T here, as .to(T) does):
//   xc[b, t] = silu(bconv + sum_k xs[b, t - K + 1 + k] wconv[k])
// with xs zero before t = 0 of each batch row, in the chain's roundings: each
// product rounded to T, the first tap taken as is and the padding's products
// computed (signed zeros as the chain's), the taps added in order with a
// rounding after each add, then the bias added and rounded (float32:
// __fmul_rn / __fadd_rn, which nvcc cannot contract into an fma; bf16:
// lfsr::mul_rn_bf16x2 / add_rn_bf16x2, each one rounding, which is what
// PyTorch's float32 op rounded to bf16 gives), then SiLU as PyTorch's CUDA
// kernel computes it, x / (1 + expf(-x)) in float32, rounded to T: the chain
// bit for bit.
//
// What bounds it on this card: an output costs 2K + 4 operations against
// 2 sizeof(T) bytes, far below the roofline's knee: bytes. At the Synth
// dispatch that is 0.66 GB, 0.198 ms at 3.35 TB/s. But SiLU's exact expf and
// IEEE division take ~20 instructions an element, which at bf16's 4 bytes an
// element would hold the SMs' issue near its limit. So in bf16 a CTA first
// stages the SiLU of every one of the 65536 bf16 inputs (the same formula,
// rounded the same way: the same bits) in shared memory, and an output's SiLU
// is one lookup by the bits of its pre-activation; float32, at 8 bytes an
// element, computes it. The design reads each row once and writes it once:
//  - a thread owns one lane of a row (16 bytes: 8 bf16 or 4 float32
//    channels; one channel where Di or the row stride is not a multiple of
//    the lane, or xs is not 16-byte aligned) down a run of consecutive
//    positions of one batch row. It keeps the last K - 1 rows in registers,
//    so a row is loaded once, but for the K - 1 rows of halo before a run;
//  - it issues the loads of kAhead rows before it computes them, and stores
//    each output row's lane as one 16-byte store;
//  - its taps and bias live in registers, rounded to T once;
//  - the plan (ops/scan.conv_silu_plan) gives a CTA runs of one channel
//    block's lanes and picks the run length from (B, L) so that all the runs
//    fit one wave of the CTAs an SM holds (Shape: bf16 one CTA of 512
//    threads beside its 128 KB table, float32 two of 256).
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kAhead = 8;       // rows a thread loads before it computes them
constexpr int kMaxTaps = 8;
constexpr int kTable = 1 << 16;  // bf16 inputs of the SiLU table

// A CTA's threads and the CTAs an SM holds (ops/scan.CONV_SILU_SHAPE); bf16
// with its SiLU table in shared memory
template <typename T> struct Shape {
  static constexpr int kThreads = 256, kCtasPerSm = 2;  // at most 128 registers: no spills
  static constexpr size_t kSmem = 0;
};
template <> struct Shape<bf16> {
  static constexpr int kThreads = 512, kCtasPerSm = 1;
  static constexpr size_t kSmem = kTable * sizeof(unsigned short);
};

struct Params {
  const void* x;        // xs: row (b, t) at x + (b L + t) sx, of T
  long long sx;         // its row stride, in elements
  const float* w;       // wconv: tap k of channel c at w[k swk + c swd]
  long long swk, swd;
  const float* bias;    // bconv [Di]
  void* y;              // xc [B, L, Di] of T, contiguous
  int B, L, Di;
  int run;              // positions a run (a thread's rows)
  int lanes;            // lanes a row
  int lanes_cta;        // lanes a CTA covers: one channel block
  int runs_cta;         // runs a CTA
};

// VW channels of a row as a thread holds them: bf16 as bf16x2 words (one
// word at VW 1, its high half unused), float32 as floats
template <typename T, int VW> struct Lane {
  static constexpr int N = std::is_same<T, bf16>::value ? (VW > 1 ? VW / 2 : 1) : VW;
  using Word = typename std::conditional<std::is_same<T, bf16>::value, uint32_t, float>::type;
  Word v[N];
};

template <typename T, int VW>
__device__ __forceinline__ Lane<T, VW> zero_lane() {
  Lane<T, VW> r;
#pragma unroll
  for (int j = 0; j < Lane<T, VW>::N; ++j) r.v[j] = 0;  // +0, as F.pad's
  return r;
}

// a row's lane: one 16-byte load, or one element
template <typename T, int VW>
__device__ __forceinline__ Lane<T, VW> load_lane(const T* p) {
  Lane<T, VW> r;
  if constexpr (VW * sizeof(T) == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    static_assert(sizeof(r.v) == 16, "a lane is 16 bytes");
    memcpy(r.v, &q, 16);
  } else if constexpr (std::is_same<T, bf16>::value) {
    r.v[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <typename T, int VW>
__device__ __forceinline__ void store_lane(T* p, const Lane<T, VW>& o) {
  if constexpr (VW * sizeof(T) == 16) {
    uint4 q;
    memcpy(&q, o.v, 16);
    *reinterpret_cast<uint4*>(p) = q;
  } else if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)(o.v[0] & 0xffffu);
  } else {
    *p = o.v[0];
  }
}

// VW float32 values at src[j stride] in T (bf16: rounded to nearest even)
template <typename T, int VW>
__device__ __forceinline__ Lane<T, VW> param_lane(const float* src, long long stride) {
  float f[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) f[j] = src[j * stride];
  Lane<T, VW> r;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int j = 0; j < Lane<T, VW>::N; ++j)
      r.v[j] = lfsr::pack_bf16(f[2 * j], VW > 1 ? f[2 * j + 1] : 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) r.v[j] = f[j];
  }
  return r;
}

// PyTorch's CUDA SiLU (ActivationSiluKernel.cu) in float32
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// one output row's lane from the window (win[K - 1] the current row); bf16
// takes SiLU from the table (tab[bits of x] = bits of silu(x))
template <typename T, int VW, int K>
__device__ __forceinline__ Lane<T, VW> conv_silu_row(const Lane<T, VW> (&win)[K],
                                                     const Lane<T, VW> (&w)[K],
                                                     const Lane<T, VW>& bias,
                                                     const unsigned short* tab) {
  Lane<T, VW> o;
#pragma unroll
  for (int j = 0; j < Lane<T, VW>::N; ++j) {
    if constexpr (std::is_same<T, bf16>::value) {
      uint32_t acc = lfsr::mul_rn_bf16x2(win[0].v[j], w[0].v[j]);
#pragma unroll
      for (int k = 1; k < K; ++k)
        acc = lfsr::add_rn_bf16x2(acc, lfsr::mul_rn_bf16x2(win[k].v[j], w[k].v[j]));
      acc = lfsr::add_rn_bf16x2(bias.v[j], acc);
      o.v[j] = (uint32_t)tab[acc & 0xffffu] | ((uint32_t)tab[acc >> 16] << 16);
    } else {
      float acc = __fmul_rn(win[0].v[j], w[0].v[j]);
#pragma unroll
      for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(win[k].v[j], w[k].v[j]));
      o.v[j] = silu(__fadd_rn(bias.v[j], acc));
    }
  }
  return o;
}

template <typename T, int VW, int K>
__global__ void __launch_bounds__(Shape<T>::kThreads, Shape<T>::kCtasPerSm)
    conv_silu_kernel(const Params p) {
  extern __shared__ unsigned short tab[];  // bf16: [kTable], by the input's bits
  if constexpr (std::is_same<T, bf16>::value) {
    for (int i = threadIdx.x; i < kTable; i += Shape<T>::kThreads) {
      const float x = __bfloat162float(__ushort_as_bfloat16((unsigned short)i));
      tab[i] = __bfloat16_as_ushort(__float2bfloat16_rn(silu(x)));
    }
    __syncthreads();
  }
  // a thread: lane `lane` of the rows of run r (a CTA holds runs_cta runs of
  // lanes_cta lanes; grid.y the channel blocks)
  const int lane_in = threadIdx.x % p.lanes_cta, run_in = threadIdx.x / p.lanes_cta;
  const int lane = blockIdx.y * p.lanes_cta + lane_in;
  if (run_in >= p.runs_cta || lane >= p.lanes) return;
  const int runs_row = (p.L + p.run - 1) / p.run;
  const long long r = (long long)blockIdx.x * p.runs_cta + run_in;
  if (r >= (long long)p.B * runs_row) return;
  const int b = (int)(r / runs_row);
  const int t0 = (int)(r - (long long)b * runs_row) * p.run;
  const int nr = min(p.run, p.L - t0);
  const int c = lane * VW;

  Lane<T, VW> w[K], win[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = param_lane<T, VW>(p.w + k * p.swk + c * p.swd, p.swd);
  const Lane<T, VW> bias = param_lane<T, VW>(p.bias + c, 1);

  const T* x = static_cast<const T*>(p.x) + ((long long)b * p.L + t0) * p.sx + c;
  T* y = static_cast<T*>(p.y) + ((long long)b * p.L + t0) * p.Di + c;
  // the halo: the K - 1 positions before t0, zeros before t = 0
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int back = K - 1 - j;
    win[j] = t0 >= back ? load_lane<T, VW>(x - back * p.sx) : zero_lane<T, VW>();
  }
  for (int i = 0; i < nr; i += kAhead) {
    Lane<T, VW> in[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (i + u < nr) in[u] = load_lane<T, VW>(x + (long long)(i + u) * p.sx);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (i + u >= nr) break;
      win[K - 1] = in[u];
      store_lane<T, VW>(y + (long long)(i + u) * p.Di,
                        conv_silu_row<T, VW, K>(win, w, bias, tab));
#pragma unroll
      for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
    }
  }
}

template <typename T, int VW, int K>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t s) {
  const cudaError_t e = lfsr::set_smem((const void*)conv_silu_kernel<T, VW, K>, Shape<T>::kSmem);
  if (e != cudaSuccess) return e;
  conv_silu_kernel<T, VW, K><<<grid, Shape<T>::kThreads, Shape<T>::kSmem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t by_taps(const Params& p, int K, dim3 grid, cudaStream_t s) {
  switch (K) {
    case 1: return launch<T, VW, 1>(p, grid, s);
    case 2: return launch<T, VW, 2>(p, grid, s);
    case 3: return launch<T, VW, 3>(p, grid, s);
    case 4: return launch<T, VW, 4>(p, grid, s);
    case 5: return launch<T, VW, 5>(p, grid, s);
    case 6: return launch<T, VW, 6>(p, grid, s);
    case 7: return launch<T, VW, 7>(p, grid, s);
    case 8: return launch<T, VW, 8>(p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xs rows at stride sx (elements) of dtype (0 float32, 1 bfloat16); wconv
// [K, Di] float32 at strides (swk, swd); bconv [Di] float32; xc [B, L, Di] of
// dtype, contiguous. vec: 16-byte lanes (Di and sx multiples of 16 /
// sizeof(T), xs 16-byte aligned), else one channel a lane. run, lanes_cta,
// runs_cta and the grid come from ops/scan.conv_silu_plan.
LFSR_EXPORT int lfsr_conv_silu(const void* x, long long sx, const void* w, long long swk,
                               long long swd, const void* bias, void* y, int B, int L, int Di,
                               int K, int run, int lanes_cta, int runs_cta, int grid_x,
                               int grid_y, int vec, int dtype, void* stream) {
  const int vw = vec ? (dtype == lfsr::kBF16 ? 8 : 4) : 1;
  const int threads = dtype == lfsr::kBF16 ? Shape<bf16>::kThreads : Shape<float>::kThreads;
  if (B < 1 || L < 1 || Di < 1 || K < 1 || K > kMaxTaps || run < 1 || lanes_cta < 1 ||
      runs_cta < 1 || lanes_cta * runs_cta > threads || grid_x < 1 || grid_y < 1 ||
      Di % vw || sx % vw || (long long)grid_y * lanes_cta < Di / vw ||
      (long long)grid_x * runs_cta < (long long)B * ((L + run - 1) / run))
    return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.sx = sx;
  p.w = static_cast<const float*>(w);
  p.swk = swk;
  p.swd = swd;
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.B = B;
  p.L = L;
  p.Di = Di;
  p.run = run;
  p.lanes = Di / vw;
  p.lanes_cta = lanes_cta;
  p.runs_cta = runs_cta;
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kBF16)
    return vec ? by_taps<bf16, 8>(p, K, grid, s) : by_taps<bf16, 1>(p, K, grid, s);
  if (dtype == lfsr::kF32)
    return vec ? by_taps<float, 4>(p, K, grid, s) : by_taps<float, 1>(p, K, grid, s);
  return cudaErrorInvalidValue;
}
