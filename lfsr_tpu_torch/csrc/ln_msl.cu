// K7 — fused LayerNorm + MultiScaleLocal front of the LFVSSMBlock.
//
// Replaces lfsr_tpu/ops/pallas_block.py::_ln_msl_kernel (ln_msl). For an
// [B, H, W, C] map x, with c4 = C/4 head channels and Cr = C - c4:
//   xn    = LayerNorm(x)                 f32 statistics, flax fast variance
//                                        max(E[x^2] - E[x]^2, 0), eps; rounded to x's dtype
//   rest  = depthwise3x3(xn[..., c4:])   zero padding applied to xn; the 9 taps
//                                        accumulated in (ky, kx) order in x's dtype
//   y     = xn[..., :c4] @ whm + rest @ wrest   each product f32-accumulated,
//                                               rounded to x's dtype, then summed
//   local = lrelu(y, slope) + xn
// and returns (xn, local). whm [c4, C] is the head 1x1 folded through the
// mixing 1x1, wrest [Cr, C] the mixing rows of the rest, wk [3, 3, Cr].
//
// What bounds it on this card: at the whole-scene point ([4, 720, 720, 64]
// bfloat16) it reads x once and writes xn and local: about 0.8 GB of HBM
// traffic, ~0.24 ms at 3.35 TB/s. The two small products are ~8.5 GFMA,
// comparable in time to that traffic when run as scalar float32 FMAs, so
// the kernel aims to touch HBM once per pixel and keep the products' operand
// reads cheap.
//
// Design: one block per 8 x 16 output tile. The tile plus a one-pixel halo
// of x is LayerNorm'd once (one warp per pixel) into shared memory, already
// rounded to the I/O dtype, with out-of-image halo pixels set to 0 (the
// conv's zero padding of xn); interior pixels are written to xn in HBM from
// the same pass. The depthwise taps read that staged tile and keep rest in
// shared memory. The products then run with whm/wrest staged in shared
// memory as float32: a thread owns one pixel and 16 output channels, so per
// input channel it does one activation read (consecutive pixels, distinct
// banks) and four broadcast float4 weight reads for 16 FMAs. bfloat16 mode
// rounds every product and partial sum exactly where the plain twin does.
// Tensor cores for the products, TMA for the tile and a tuned tile size are
// later work.
#include "common.cuh"

namespace {

constexpr int kTH = 8;           // output tile rows
constexpr int kTW = 16;          // output tile columns
constexpr int kHaloW = kTW + 2;  // staged tile columns
constexpr int kStaged = (kTH + 2) * kHaloW;
constexpr int kPixels = kTH * kTW;
constexpr int kThreads = 256;
constexpr int kGroup = 16;       // output channels per thread in the products
constexpr int kMaxC = 128;       // LayerNorm keeps C/32 <= 4 values per lane

// value as stored in T, returned as float
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_msl_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ whm,
              const T* __restrict__ wrest, const T* __restrict__ wk, T* __restrict__ xn_out,
              T* __restrict__ local_out, int H, int W, int C, int c4, float slope, float eps) {
  const int Cr = C - c4;
  const int ld = C + 1;    // padded row stride of the staged xn tile
  const int ldr = Cr + 1;  // padded row stride of rest
  extern __shared__ float smem[];
  float* s_whm = smem;                 // [c4][C]  (16-byte aligned: float4 reads)
  float* s_wr = s_whm + c4 * C;        // [Cr][C]
  float* s_wk = s_wr + Cr * C;         // [9][Cr]
  float* s_g = s_wk + 9 * Cr;          // [C]
  float* s_b = s_g + C;                // [C]
  float* s_xn = s_b + C;               // [kStaged][ld]
  float* s_rest = s_xn + kStaged * ld; // [kPixels][ldr]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * kTH, b = blockIdx.z;
  auto pix = [&](int hh, int ww) -> size_t { return (((size_t)b * H + hh) * W + ww) * C; };

  for (int i = tid; i < c4 * C; i += kThreads) s_whm[i] = lfsr::load(whm + i);
  for (int i = tid; i < Cr * C; i += kThreads) s_wr[i] = lfsr::load(wrest + i);
  for (int i = tid; i < 9 * Cr; i += kThreads) s_wk[i] = lfsr::load(wk + i);
  for (int i = tid; i < C; i += kThreads) {
    s_g[i] = gamma[i];
    s_b[i] = beta[i];
  }
  __syncthreads();

  // 1. LayerNorm of the tile and its halo, one warp per staged pixel
  for (int q = warp; q < kStaged; q += kThreads / 32) {
    const int hh = h0 - 1 + q / kHaloW, ww = w0 - 1 + q % kHaloW;
    float* row = s_xn + q * ld;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) {
      for (int c = lane; c < C; c += 32) row[c] = 0.f;
      continue;
    }
    const T* xr = x + pix(hh, ww);
    float v[kMaxC / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? lfsr::load(xr + c) : 0.f;
      s += v[i];
      ss += v[i] * v[i];
    }
    const float mean = lfsr::warp_sum(s) / C;
    const float var = fmaxf(lfsr::warp_sum(ss) / C - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    const bool interior = q / kHaloW >= 1 && q / kHaloW <= kTH && q % kHaloW >= 1 &&
                          q % kHaloW <= kTW;
    T* xo = xn_out + pix(hh, ww);
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float r = rnd<T>((v[i] - mean) * (inv * s_g[c]) + s_b[c]);
        row[c] = r;
        if (interior) lfsr::store(xo + c, r);
      }
    }
  }
  __syncthreads();

  // 2. depthwise 3x3 over the rest channels, taps in (ky, kx) order
  for (int i = tid; i < kPixels * Cr; i += kThreads) {
    const int p = i / Cr, k = i % Cr;
    const int py = p / kTW, px = p % kTW;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float xv = s_xn[((py + t / 3) * kHaloW + px + t % 3) * ld + c4 + k];
      const float term = rnd<T>(__fmul_rn(xv, s_wk[t * Cr + k]));
      acc = t == 0 ? term : rnd<T>(__fadd_rn(acc, term));
    }
    s_rest[p * ldr + k] = acc;
  }
  __syncthreads();

  // 3. head and mix products, lrelu, residual; a thread owns (pixel, 16 channels)
  const int groups = C / kGroup;
  for (int i = tid; i < kPixels * groups; i += kThreads) {
    const int p = i % kPixels, cg = (i / kPixels) * kGroup;
    const int py = p / kTW, px = p % kTW;
    const int hh = h0 + py, ww = w0 + px;
    if (hh >= H || ww >= W) continue;
    const float* xr = s_xn + ((py + 1) * kHaloW + px + 1) * ld;
    const float* rr = s_rest + p * ldr;
    float acc_h[kGroup], acc_m[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc_h[j] = acc_m[j] = 0.f;
    for (int k = 0; k < c4; ++k) {
      const float a = xr[k];
      const float4* wrow = reinterpret_cast<const float4*>(s_whm + k * C + cg);
#pragma unroll
      for (int j = 0; j < kGroup / 4; ++j) {
        const float4 w = wrow[j];
        acc_h[4 * j] = fmaf(a, w.x, acc_h[4 * j]);
        acc_h[4 * j + 1] = fmaf(a, w.y, acc_h[4 * j + 1]);
        acc_h[4 * j + 2] = fmaf(a, w.z, acc_h[4 * j + 2]);
        acc_h[4 * j + 3] = fmaf(a, w.w, acc_h[4 * j + 3]);
      }
    }
    for (int k = 0; k < Cr; ++k) {
      const float a = rr[k];
      const float4* wrow = reinterpret_cast<const float4*>(s_wr + k * C + cg);
#pragma unroll
      for (int j = 0; j < kGroup / 4; ++j) {
        const float4 w = wrow[j];
        acc_m[4 * j] = fmaf(a, w.x, acc_m[4 * j]);
        acc_m[4 * j + 1] = fmaf(a, w.y, acc_m[4 * j + 1]);
        acc_m[4 * j + 2] = fmaf(a, w.z, acc_m[4 * j + 2]);
        acc_m[4 * j + 3] = fmaf(a, w.w, acc_m[4 * j + 3]);
      }
    }
    T* lo = local_out + pix(hh, ww) + cg;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float y = rnd<T>(__fadd_rn(rnd<T>(acc_h[j]), rnd<T>(acc_m[j])));
      if (!(y >= 0.f)) y = rnd<T>(__fmul_rn(slope, y));
      lfsr::store(lo + j, __fadd_rn(y, xr[cg + j]));
    }
  }
}

size_t smem_bytes(int C, int c4) {
  const int Cr = C - c4;
  return sizeof(float) * ((size_t)c4 * C + (size_t)Cr * C + 9 * Cr + 2 * C +
                          (size_t)kStaged * (C + 1) + (size_t)kPixels * (Cr + 1));
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* whm,
                   const void* wrest, const void* wk, void* xn, void* local, int B, int H, int W,
                   int C, int c4, float slope, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes(C, c4);
  cudaError_t e = cudaFuncSetAttribute(ln_msl_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  ln_msl_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(whm), static_cast<const T*>(wrest),
      static_cast<const T*>(wk), static_cast<T*>(xn), static_cast<T*>(local), H, W, C, c4, slope,
      eps);
  return cudaGetLastError();
}

}  // namespace

LFSR_EXPORT int lfsr_ln_msl(const void* x, const void* gamma, const void* beta, const void* whm,
                            const void* wrest, const void* wk, void* xn, void* local, int B,
                            int H, int W, int C, int c4, float slope, float eps, int dtype,
                            void* stream) {
  if (C < kGroup || C > kMaxC || C % kGroup || c4 < 1 || c4 >= C || B < 1 || H < 1 || W < 1 ||
      B > 65535 || (H + kTH - 1) / kTH > 65535)
    return cudaErrorInvalidValue;
  if (smem_bytes(C, c4) > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return launch<float>(x, gamma, beta, whm, wrest, wk, xn, local, B, H, W, C, c4, slope, eps, s);
  if (dtype == lfsr::kBF16)
    return launch<__nv_bfloat16>(x, gamma, beta, whm, wrest, wk, xn, local, B, H, W, C, c4,
                                 slope, eps, s);
  return cudaErrorInvalidValue;
}
