// K10 — the HLFR tail: expansion matmul + LeakyReLU + the folded 3x3 out-conv.
//
// Replaces lfsr_tpu/ops/pallas_head.py::hlfr_tail (body _tail_kernel), whose
// function is hlfr_tail_ref (the chain of lfsr_tpu/models/lfmambax.py
// :551-572). For y [B, H, W, C], w1 [C, Cz], the folded taps W36 [Cz, 9 rr]
// (column k rr + j = kf[ky, kx, :, j], k = 3 ky + kx) and a scalar bias:
//   z   = round(y . w1)                       (float32 sums, rounded to T)
//   z   = z >= 0 ? z : round(slope z)
//   t   = zpad . W36                          (float32 sums; zpad: z with a
//                                              zero 1-pixel border)
//   out[b, y, x, j] = bias + sum_{ky, kx} t[b, y + ky, x + kx, k rr + j]
// out is float32 [B, H, W, rr]. T is bfloat16 or float32; in float32
// nothing rounds (round() is the identity), as in the reference.
//
// What bounds it on this card: the work is two products per pixel,
// C x Cz and Cz x 36 (the flagship: 64 x 256 and 256 x 36, 2 x 25,600
// FLOPs), against 128 bytes of y read and 16 of out written: 400 FLOPs per
// byte, above the H100's ~295 for bf16 tensor cores, so the bound is the
// tensor cores' rate (Synth [4, 1440, 1440, 64]: 425 GFLOP, 0.43 ms). The
// plain chain writes the [.., 256] z (bf16), a padded copy, an f32 copy
// of that and a [.., 36] product to HBM, ~19 GB live at a Synth dispatch.
//
// Design: nothing of z or t reaches HBM. A CTA owns a 16 x 16 tile of
// output pixels and stages its 18 x 18 halo of y (zeros outside the image:
// z has no bias and lrelu(0) = 0, so zero y is zero-padded z) in shared
// memory, with w1 and W36 transposed there once per CTA (persistent CTAs
// walk the tiles). The halo's 324 pixels are 21 m-tiles of 16 rows.
//  - bfloat16 (tail_mma_kernel): 7 warps, 3 m-tiles each. Per m-tile and
//    per 16 channels of z: z [16, 16] by mma.sync m16n8k16 (bf16 in, f32
//    sums) from y's fragments held in registers; rounded, lrelu'd and
//    packed in registers, the accumulator fragment of z is the A fragment
//    of the next product (as FlashAttention's P.V), t [16, 40] += z . W36
//    (5 n-tiles of 8 columns, 36 used). t stays in registers until all
//    warps are done with y; then it goes to shared memory over y's halo.
//  - float32 (tail_f32_kernel, the reference's float32 checks): one halo
//    pixel per thread on the CUDA cores, y's C values and t's 36 sums in
//    registers, w1 and W36 read as broadcasts from shared memory.
//  The nine shifted adds read t out of shared memory, in the reference's
//  order (bias, then k = 0..8), one (pixel, j) per thread.
// Shapes the wrapper checks: C in {16, 32, 48, 64}, Cz a multiple of 16,
// rr = 4 (the last pixel-shuffle stage of r = 2, scales 2 and 4).
#include "common.cuh"

namespace {

using lfsr::ld32;
using lfsr::mma_bf16;

constexpr int kTH = 16, kTW = 16;            // output pixels per tile
constexpr int kHW = kTW + 2;                 // halo width
constexpr int kHalo = (kTH + 2) * kHW;       // 324 halo pixels
constexpr int kRR = 4;                       // output channels (r * r)
constexpr int kTaps = 9 * kRR;               // 36 columns of W36
constexpr int kRows = (kHalo + 15) / 16 * 16;  // 336: 21 m-tiles of 16
constexpr int kMmaWarps = 7;                 // tail_mma_kernel: 3 m-tiles per warp
constexpr int kMPerWarp = kRows / 16 / kMmaWarps;
constexpr int kNT = (kTaps + 7) / 8;         // 5 n-tiles of W36's columns
constexpr int kF32Threads = 352;             // tail_f32_kernel: >= kHalo, whole warps

static_assert(kRows / 16 == kMmaWarps * kMPerWarp, "m-tiles split evenly over the warps");

struct TailParams {
  const void* y;      // [B, H, W, C] (T), 16-byte aligned
  const void* w1;     // [C, Cz] (T)
  const void* w36;    // [Cz, kTaps] (T)
  const float* bias;  // [1]
  float* out;         // [B, H, W, kRR]
  int B, H, W, Cz;
  float slope;
};

__device__ __forceinline__ void tile_origin(const TailParams& p, int tile, int& b, int& y0,
                                            int& x0) {
  const int tx = (p.W + kTW - 1) / kTW, ty = (p.H + kTH - 1) / kTH;
  b = tile / (tx * ty);
  const int r = tile % (tx * ty);
  y0 = (r / tx) * kTH;
  x0 = (r % tx) * kTW;
}

// out = bias + the nine shifted taps of t_s [kRows][kTaps], one (pixel, j)
// per thread, k in the reference's order
__device__ __forceinline__ void shifted_adds(const TailParams& p, const float* t_s, int b, int y0,
                                             int x0) {
  const float bias = p.bias[0];
  for (int i = threadIdx.x; i < kTH * kTW * kRR; i += blockDim.x) {
    const int px = i / kRR, j = i % kRR;
    const int oy = px / kTW, ox = px % kTW;
    if (y0 + oy >= p.H || x0 + ox >= p.W) continue;
    float v = bias;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        v += t_s[((oy + ky) * kHW + ox + kx) * kTaps + (ky * 3 + kx) * kRR + j];
    p.out[(((size_t)b * p.H + y0 + oy) * p.W + x0 + ox) * kRR + j] = v;
  }
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores
// --------------------------------------------------------------------------

// lrelu of two z sums, each rounded to bf16 first and the product again
// (torch's where(z >= 0, z, slope * z) on a bf16 z), packed low-first
__device__ __forceinline__ uint32_t lrelu_pack(float lo, float hi, float slope) {
  float v[2] = {lo, hi};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float z = __bfloat162float(__float2bfloat16_rn(v[i]));
    v[i] = z >= 0.f ? z : __bfloat162float(__float2bfloat16_rn(slope * z));
  }
  return lfsr::pack_bf16(v[0], v[1]);
}

template <int C>
__global__ void __launch_bounds__(32 * kMmaWarps, 2) tail_mma_kernel(const TailParams p) {
  constexpr int LDY = C + 8;  // bf16 per staged row of y and of w1^T: conflict-free fragments
  constexpr int KS = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cz = p.Cz, LDZ = Cz + 8;
  __nv_bfloat16* w1t = reinterpret_cast<__nv_bfloat16*>(smem);  // [Cz][LDY]
  __nv_bfloat16* w36t = w1t + (size_t)Cz * LDY;                  // [kNT * 8][LDZ]
  __nv_bfloat16* ys = w36t + (size_t)kNT * 8 * LDZ;              // [kRows][LDY]
  float* t_s = reinterpret_cast<float*>(ys);                     // [kRows][kTaps], after y

  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(p.w1);
  const __nv_bfloat16* w36 = static_cast<const __nv_bfloat16*>(p.w36);
  for (int i = threadIdx.x; i < C * Cz; i += blockDim.x)
    w1t[(i % Cz) * LDY + i / Cz] = w1[i];
  for (int i = threadIdx.x; i < kNT * 8 * Cz; i += blockDim.x) {
    const int n = i / Cz, k = i % Cz;
    w36t[n * LDZ + k] = n < kTaps ? w36[(size_t)k * kTaps + n] : __float2bfloat16_rn(0.f);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles = p.B * ((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  const __nv_bfloat16* yg = static_cast<const __nv_bfloat16*>(p.y);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, y0, x0;
    tile_origin(p, tile, b, y0, x0);
    __syncthreads();  // the weights are staged; the last tile's t_s is read
    // y's halo, 16 bytes at a time, zeros outside the image and past kHalo
    for (int i = threadIdx.x; i < kRows * (C / 8); i += blockDim.x) {
      const int hp = i / (C / 8), part = i % (C / 8);
      const int gy = y0 - 1 + hp / kHW, gx = x0 - 1 + hp % kHW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (hp < kHalo && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
        v = *reinterpret_cast<const uint4*>(yg + (((size_t)b * p.H + gy) * p.W + gx) * C +
                                            part * 8);
      *reinterpret_cast<uint4*>(ys + hp * LDY + part * 8) = v;
    }
    __syncthreads();

    float acc[kMPerWarp][kNT][4];
#pragma unroll
    for (int mi = 0; mi < kMPerWarp; ++mi) {
      const int m0 = (warp + mi * kMmaWarps) * 16;
      uint32_t a[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // rows m0 + lane % 16, columns ks * 16 + (lane / 16) * 8: a0..a3
        lfsr::ldmatrix_x4(a[ks], ys + (m0 + lane % 16) * LDY + ks * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][nt][c] = 0.f;
      for (int zs = 0; zs < Cz; zs += 16) {
        float z[2][4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const __nv_bfloat16* wb = w1t + (zs + h * 8 + g) * LDY + ks * 16 + 2 * t;
            mma_bf16(z[h], a[ks], ld32(wb), ld32(wb + 8));
          }
        // the accumulators of z's two n-tiles are the A fragment over its 16 channels
        const uint32_t za[4] = {lrelu_pack(z[0][0], z[0][1], p.slope),
                                lrelu_pack(z[0][2], z[0][3], p.slope),
                                lrelu_pack(z[1][0], z[1][1], p.slope),
                                lrelu_pack(z[1][2], z[1][3], p.slope)};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const __nv_bfloat16* wb = w36t + (nt * 8 + g) * LDZ + zs + 2 * t;
          mma_bf16(acc[mi][nt], za, ld32(wb), ld32(wb + 8));
        }
      }
    }
    __syncthreads();  // every warp is done with y: t_s overwrites it
#pragma unroll
    for (int mi = 0; mi < kMPerWarp; ++mi) {
      const int m0 = (warp + mi * kMmaWarps) * 16;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < kTaps) {
          t_s[(m0 + g) * kTaps + col] = acc[mi][nt][0];
          t_s[(m0 + g) * kTaps + col + 1] = acc[mi][nt][1];
          t_s[(m0 + g + 8) * kTaps + col] = acc[mi][nt][2];
          t_s[(m0 + g + 8) * kTaps + col + 1] = acc[mi][nt][3];
        }
      }
    }
    __syncthreads();
    shifted_adds(p, t_s, b, y0, x0);
  }
}

size_t mma_smem(int C, int Cz) {
  const size_t y = (size_t)kRows * (C + 8) * 2, t = (size_t)kRows * kTaps * 4;
  return (size_t)Cz * (C + 8) * 2 + (size_t)kNT * 8 * (Cz + 8) * 2 + (y > t ? y : t);
}

// --------------------------------------------------------------------------
// float32: CUDA cores
// --------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kF32Threads) tail_f32_kernel(const TailParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cz = p.Cz;
  float* w1t = reinterpret_cast<float*>(smem);  // [Cz][C]
  float* w36s = w1t + (size_t)Cz * C;           // [Cz][kTaps]
  float* t_s = w36s + (size_t)Cz * kTaps;       // [kRows][kTaps]
  const float* w1 = static_cast<const float*>(p.w1);
  for (int i = threadIdx.x; i < C * Cz; i += blockDim.x) w1t[(i % Cz) * C + i / Cz] = w1[i];
  for (int i = threadIdx.x; i < Cz * kTaps; i += blockDim.x)
    w36s[i] = static_cast<const float*>(p.w36)[i];

  const int hp = threadIdx.x;  // this thread's halo pixel
  const int tiles = p.B * ((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  const float* yg = static_cast<const float*>(p.y);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, y0, x0;
    tile_origin(p, tile, b, y0, x0);
    __syncthreads();  // the weights are staged; the last tile's t_s is read
    if (hp < kHalo) {
      const int gy = y0 - 1 + hp / kHW, gx = x0 - 1 + hp % kHW;
      float yv[C];
      const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const float4* src = inside ? reinterpret_cast<const float4*>(
                                       yg + (((size_t)b * p.H + gy) * p.W + gx) * C)
                                 : nullptr;
#pragma unroll
      for (int c = 0; c < C / 4; ++c) {
        const float4 v = inside ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
        yv[4 * c] = v.x; yv[4 * c + 1] = v.y; yv[4 * c + 2] = v.z; yv[4 * c + 3] = v.w;
      }
      float tv[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) tv[k] = 0.f;
      for (int j = 0; j < Cz; ++j) {
        const float4* wc = reinterpret_cast<const float4*>(w1t + (size_t)j * C);
        float z = 0.f;
#pragma unroll
        for (int c = 0; c < C / 4; ++c) {
          const float4 w = wc[c];
          z = fmaf(yv[4 * c], w.x, z);
          z = fmaf(yv[4 * c + 1], w.y, z);
          z = fmaf(yv[4 * c + 2], w.z, z);
          z = fmaf(yv[4 * c + 3], w.w, z);
        }
        z = z >= 0.f ? z : p.slope * z;
        const float4* wt = reinterpret_cast<const float4*>(w36s + (size_t)j * kTaps);
#pragma unroll
        for (int k = 0; k < kTaps / 4; ++k) {
          const float4 w = wt[k];
          tv[4 * k] = fmaf(z, w.x, tv[4 * k]);
          tv[4 * k + 1] = fmaf(z, w.y, tv[4 * k + 1]);
          tv[4 * k + 2] = fmaf(z, w.z, tv[4 * k + 2]);
          tv[4 * k + 3] = fmaf(z, w.w, tv[4 * k + 3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) t_s[hp * kTaps + k] = tv[k];
    }
    __syncthreads();
    shifted_adds(p, t_s, b, y0, x0);
  }
}

size_t f32_smem(int C, int Cz) {
  return sizeof(float) * ((size_t)Cz * C + (size_t)Cz * kTaps + (size_t)kRows * kTaps);
}

// one persistent CTA per resident slot, at most one per tile
template <typename Kernel>
cudaError_t launch_tail(Kernel kernel, int threads, size_t smem, const TailParams& p,
                        cudaStream_t stream) {
  cudaError_t e = lfsr::set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles =
      (long long)p.B * ((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_tail(const TailParams& p, int dtype, cudaStream_t s) {
  if (dtype == lfsr::kBF16)
    return launch_tail(tail_mma_kernel<C>, 32 * kMmaWarps, mma_smem(C, p.Cz), p, s);
  if (dtype == lfsr::kF32)
    return launch_tail(tail_f32_kernel<C>, kF32Threads, f32_smem(C, p.Cz), p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// y [B, H, W, C], w1 [C, Cz] and w36 [Cz, 36] of ``dtype`` (contiguous, y
// 16-byte aligned); bias [1] and out [B, H, W, 4] float32.
LFSR_EXPORT int lfsr_hlfr_tail(const void* y, const void* w1, const void* w36, const void* bias,
                               void* out, int B, int H, int W, int C, int Cz, float slope,
                               int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cz < 16 || Cz % 16 != 0) return cudaErrorInvalidValue;
  TailParams p{};
  p.y = y; p.w1 = w1; p.w36 = w36;
  p.bias = static_cast<const float*>(bias); p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.Cz = Cz; p.slope = slope;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return dispatch_tail<16>(p, dtype, s);
    case 32: return dispatch_tail<32>(p, dtype, s);
    case 48: return dispatch_tail<48>(p, dtype, s);
    case 64: return dispatch_tail<64>(p, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
