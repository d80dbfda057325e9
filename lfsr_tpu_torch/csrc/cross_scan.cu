// K4 / K5 — the 4-way cross-scan permutation around the shared Mamba.
//
// Replace lfsr_tpu/ops/pallas_layout.py::_gather_kernel (cross_scan_gather)
// and ::_scatter_kernel (cross_scan_scatter). Channel quarter q of an
// [B, H, W, C] map is read in raster order q: 0 row-major, 1 reversed
// row-major, 2 column-major, 3 reversed column-major, into one [B, L, C]
// sequence (L = H*W).
//
// What bounds them on this card: both are pure data movement plus a little
// arithmetic — K4 moves 2 x 6.5 MB and K5 3 x 6.5 MB at the tiled-eval point
// ([2, 160, 160, 64] bfloat16), i.e. a few microseconds of HBM time each.
// The TPU kernels spend their effort on relayouts (per-band BlockSpecs and
// anti-diagonal MXU matmuls to reverse rows, pallas_layout.py:69-80); on
// Hopper a permutation is index arithmetic on the load, so:
//  - K4: one warp per sequence position; each lane reads its channels from
//    the source pixel of its quarter, then LayerNorm over C with warp
//    reductions (flax fast-variance form, eps from the caller).
//  - K5: a block takes kPix consecutive output pixels, gathers their
//    un-permuted rows into shared memory, and computes the 1x1 C x C mix in
//    the kernel body with W staged in shared memory (float32 accumulation,
//    as the TPU kernel's MXU dot), then writes x + scale * y.
// Coalescing of the column-major quarters is the obvious next step.
#include "common.cuh"

namespace {

constexpr int kMaxC = 128;   // channels per pixel handled by one warp (4 per lane)
constexpr int kPix = 64;     // output pixels per K5 block
constexpr int kThreads = 256;

// sequence index read by channel quarter q at pixel (hh, ww), and back
__device__ __forceinline__ long seq_index(int q, int hh, int ww, int H, int W) {
  const long L = (long)H * W;
  const long rm = (long)hh * W + ww;   // row-major
  const long cm = (long)ww * H + hh;   // column-major
  switch (q) {
    case 0: return rm;
    case 1: return L - 1 - rm;
    case 2: return cm;
    default: return L - 1 - cm;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ out, int B, int H, int W,
              int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long L = (long)H * W;
  const long pos = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (pos >= (long)B * L) return;  // uniform per warp
  const int b = (int)(pos / L);
  const long l = pos % L;
  const int g = C / 4;
  float v[kMaxC / 32];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxC / 32; ++i) {
    const int c = lane + 32 * i;
    v[i] = 0.f;
    if (c < C) {
      const int q = min(c / g, 3);
      // the permutation is an involution: the pixel read at position l is
      // the pixel whose quarter-q sequence index is l
      const long li = (q == 1 || q == 3) ? L - 1 - l : l;
      int hh, ww;
      if (q < 2) { hh = (int)(li / W); ww = (int)(li % W); }
      else       { ww = (int)(li / H); hh = (int)(li % H); }
      v[i] = lfsr::load(x + (((size_t)b * H + hh) * W + ww) * C + c);
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  s = lfsr::warp_sum(s);
  ss = lfsr::warp_sum(ss);
  const float mean = s / C;
  const float var = fmaxf(ss / C - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  T* o = out + (size_t)pos * C;
#pragma unroll
  for (int i = 0; i < kMaxC / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) lfsr::store(o + c, (v[i] - mean) * inv * gamma[c] + beta[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const T* __restrict__ seq, const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, T* __restrict__ out, int B, int H, int W,
               int C) {
  extern __shared__ float smem[];
  float* s_w = smem;            // [C][C]  (in, out)
  float* s_z = smem + C * C;    // [kPix][C + 1]
  const int ldz = C + 1;
  const long HW = (long)H * W;
  const long P = (long)B * HW;
  const long p0 = (long)blockIdx.x * kPix;
  const int g = C / 4;

  for (int i = threadIdx.x; i < C * C; i += blockDim.x) s_w[i] = lfsr::load(w + i);
  for (int i = threadIdx.x; i < kPix * C; i += blockDim.x) {
    const int pl = i / C, c = i % C;
    const long p = p0 + pl;
    float val = 0.f;
    if (p < P) {
      const int b = (int)(p / HW);
      const long r = p % HW;
      const int hh = (int)(r / W), ww = (int)(r % W);
      const long l = seq_index(min(c / g, 3), hh, ww, H, W);
      val = lfsr::load(seq + ((size_t)b * HW + l) * C + c);
    }
    s_z[pl * ldz + c] = val;
  }
  __syncthreads();
  const float sc = *scale;
  for (int i = threadIdx.x; i < kPix * C; i += blockDim.x) {
    const int pl = i / C, c = i % C;
    const long p = p0 + pl;
    if (p >= P) continue;
    const float* zr = s_z + pl * ldz;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc = fmaf(zr[k], s_w[k * C + c], acc);
    const size_t o = (size_t)p * C + c;
    lfsr::store(out + o, lfsr::load(x + o) + sc * acc);
  }
}

template <typename T>
cudaError_t launch_gather(const void* x, const void* gamma, const void* beta, void* out, int B,
                          int H, int W, int C, float eps, cudaStream_t s) {
  const long rows = (long)B * H * W;
  const int per_block = kThreads / 32;
  gather_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), B, H, W, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scatter(const void* seq, const void* x, const void* w, const void* scale,
                           void* out, int B, int H, int W, int C, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)C * C + (size_t)kPix * (C + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(scatter_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long P = (long)B * H * W;
  scatter_kernel<T><<<(unsigned)((P + kPix - 1) / kPix), kThreads, smem, s>>>(
      static_cast<const T*>(seq), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out), B, H, W, C);
  return cudaGetLastError();
}

}  // namespace

LFSR_EXPORT int lfsr_cross_scan_gather(const void* x, const void* gamma, const void* beta,
                                       void* out, int B, int H, int W, int C, float eps,
                                       int dtype, void* stream) {
  if (C < 4 || C > kMaxC || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return launch_gather<float>(x, gamma, beta, out, B, H, W, C, eps, s);
  if (dtype == lfsr::kBF16)
    return launch_gather<__nv_bfloat16>(x, gamma, beta, out, B, H, W, C, eps, s);
  return cudaErrorInvalidValue;
}

LFSR_EXPORT int lfsr_cross_scan_scatter(const void* seq, const void* x, const void* w,
                                        const void* scale, void* out, int B, int H, int W,
                                        int C, int dtype, void* stream) {
  if (C < 4 || C > kMaxC || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return launch_scatter<float>(seq, x, w, scale, out, B, H, W, C, s);
  if (dtype == lfsr::kBF16)
    return launch_scatter<__nv_bfloat16>(seq, x, w, scale, out, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
