// K7 — fused LayerNorm + MultiScaleLocal front of the LFVSSMBlock.
//
// Replaces lfsr_tpu/ops/pallas_block.py::_ln_msl_kernel (ln_msl). For an
// [B, H, W, C] map x, with c4 head channels and Cr = C - c4, in the
// weights' dtype T (the compute dtype):
//   xn    = LayerNorm(x)                 f32 statistics, flax fast variance
//                                        max(E[x^2] - E[x]^2, 0), eps; rounded to T
//   rest  = depthwise3x3(xn[..., c4:])   zero padding applied to xn; the 9 taps
//                                        accumulated in (ky, kx) order in T
//   y     = xn[..., :c4] @ whm + rest @ wrest   each product f32-accumulated,
//                                               rounded to T, then summed
//   local = lrelu(y, slope) + xn
// and returns (xn, local) in T. whm [c4, C] is the head 1x1 folded through
// the mixing 1x1, wrest [Cr, C] the mixing rows of the rest, wk [3, 3, Cr].
// x is T, or float32 with T = bfloat16: the float32-input mode, whose
// LayerNorm reads the block's float32 residual stream (JAX's plain branch,
// lfsr_tpu/models/lfmambax.py:317-318, where the TPU's K7 branch rounds x
// to bf16 first, :313-315).
//
// What bounds it on this card: at the whole-scene point ([4, 720, 720, 64]
// bfloat16) it reads x once and writes xn and local: about 0.8 GB of HBM
// traffic, ~0.24 ms at 3.35 TB/s (float32 x: 1.06 GB). The two products
// are 8.5 G multiply-adds, ~0.25 ms as float32 FMAs on the CUDA cores and
// ~0.02 ms on the tensor cores; the 9 taps of 48 channels are ~1 G bf16x2
// operations. So the kernel is bound by bytes once the products leave the
// CUDA cores and the loads overlap the arithmetic.
//
// "mma" (ln_msl_mma_kernel; T = bfloat16, the models' compute dtype):
//  - Persistent CTAs (two an SM) walk 16 x 16-pixel output tiles (8 x 16
//    above 64 channels), staged with a one-pixel halo: 324 pixels for 256
//    outputs, 1.27 LayerNorms an output pixel (1.41 for the 8 x 16 tiles of
//    "fma"). The folded whm and wrest are staged once a CTA as bf16 in
//    [out channel][in channel] order, with the depthwise taps and
//    gamma/beta.
//  - bf16 x is copied by cp.async in 16-byte granules into one of two
//    staged tiles while the other tile computes; its LayerNorm then runs in
//    place. float32 x is read by 16-byte loads, two pixels a lane group in
//    flight, and normalised in registers: only the bf16 xn is staged, so
//    shared memory does not double (the other resident CTA overlaps these
//    loads). LayerNorm takes 8 channels a lane (a lane group of 8 lanes a
//    pixel at C 64), sums by shuffles inside the group; xn goes to the
//    staged tile, and for the tile's own pixels to HBM, as 16-byte stores.
//  - A warp owns output rows of 16 pixels (m-tiles). head = xn[:, :c4] whm
//    on mma.sync m16n8k16 with A by ldmatrix from the staged tile (k past
//    c4 meets zero rows of whm; B fragments by ldmatrix, two n-tiles a
//    load). The rest's A fragments are the taps,
//    computed in registers from the staged tile as bf16x2 mul.rn and
//    add.rn (one rounding each, as the twin's bf16 multiply and add: the
//    .rn keeps ptxas from fusing them into an fma, which __hmul2/__hadd2
//    allow), then rest wrest on the tensor cores. Both products keep float32
//    sums; the epilogue (round each, add, round, lrelu, round, + xn) runs on
//    the accumulators, and a quad transpose turns them into 16-byte stores.
// "fma" (ln_msl_kernel; T = float32, the float32 model): one block per
// 8 x 16 output tile, everything float32 in shared memory, the products on
// the CUDA cores (a thread owns one pixel and 16 output channels).
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// "fma": float32
// ---------------------------------------------------------------------------

constexpr int kTH = 8;           // output tile rows
constexpr int kTW = 16;          // output tile columns
constexpr int kHaloW = kTW + 2;  // staged tile columns
constexpr int kStaged = (kTH + 2) * kHaloW;
constexpr int kPixels = kTH * kTW;
constexpr int kThreads = 256;
constexpr int kGroup = 16;       // output channels per thread in the products
constexpr int kMaxC = 128;       // LayerNorm keeps C/32 <= 4 values per lane

__global__ void __launch_bounds__(kThreads)
ln_msl_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ whm,
              const float* __restrict__ wrest, const float* __restrict__ wk,
              float* __restrict__ xn_out, float* __restrict__ local_out, int H, int W, int C,
              int c4, float slope, float eps) {
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

  for (int i = tid; i < c4 * C; i += kThreads) s_whm[i] = whm[i];
  for (int i = tid; i < Cr * C; i += kThreads) s_wr[i] = wrest[i];
  for (int i = tid; i < 9 * Cr; i += kThreads) s_wk[i] = wk[i];
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
    const float* xr = x + pix(hh, ww);
    float v[kMaxC / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? xr[c] : 0.f;
      s += v[i];
      ss += v[i] * v[i];
    }
    const float mean = lfsr::warp_sum(s) / C;
    const float var = fmaxf(lfsr::warp_sum(ss) / C - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    const bool interior = q / kHaloW >= 1 && q / kHaloW <= kTH && q % kHaloW >= 1 &&
                          q % kHaloW <= kTW;
    float* xo = xn_out + pix(hh, ww);
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float r = (v[i] - mean) * (inv * s_g[c]) + s_b[c];
        row[c] = r;
        if (interior) xo[c] = r;
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
      const float term = __fmul_rn(xv, s_wk[t * Cr + k]);
      acc = t == 0 ? term : __fadd_rn(acc, term);
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
    float* lo = local_out + pix(hh, ww) + cg;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float y = __fadd_rn(acc_h[j], acc_m[j]);
      if (!(y >= 0.f)) y = __fmul_rn(slope, y);
      lo[j] = __fadd_rn(y, xr[cg + j]);
    }
  }
}

size_t fma_smem(int C, int c4) {
  const int Cr = C - c4;
  return sizeof(float) * ((size_t)c4 * C + (size_t)Cr * C + 9 * Cr + 2 * C +
                          (size_t)kStaged * (C + 1) + (size_t)kPixels * (Cr + 1));
}

cudaError_t launch_fma(const void* x, const void* gamma, const void* beta, const void* whm,
                       const void* wrest, const void* wk, void* xn, void* local, int B, int H,
                       int W, int C, int c4, float slope, float eps, cudaStream_t s) {
  const size_t smem = fma_smem(C, c4);
  if (smem > 227 * 1024 || B > 65535 || (H + kTH - 1) / kTH > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ln_msl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  ln_msl_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(whm),
      static_cast<const float*>(wrest), static_cast<const float*>(wk), static_cast<float*>(xn),
      static_cast<float*>(local), H, W, C, c4, slope, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma": bf16 compute, float32 or bf16 x
// ---------------------------------------------------------------------------

namespace mma {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kTW = 16;          // output tile columns: one m-tile of 16 pixels a row
constexpr int kSW = kTW + 2;     // staged columns

// the tile and the LayerNorm's lanes at C channels
template <int C>
struct Geo {
  static constexpr int TH = C <= 64 ? 16 : 8;   // output rows: 2 CTAs an SM at 64
  static constexpr int SP = (TH + 2) * kSW;     // staged pixels
  static constexpr int LDX = C + 8;             // bf16 a staged row (16 x an odd number
                                                // of bytes: conflict-free ldmatrix and
                                                // 32-bit fragment reads)
  static constexpr int NT = C / 8;              // n-tiles of the output
  static constexpr int G = C <= 16 ? 2 : C <= 32 ? 4 : C <= 64 ? 8 : 16;  // lanes a pixel
  static constexpr int MT = TH / kWarps;        // m-tiles (output rows) a warp
};

struct Params {
  const void* x;                   // [B, H, W, C], float32 or bf16, 16-byte aligned
  const float* gamma;              // [C]
  const float* beta;               // [C]
  const bf16* whm;                 // [c4, C]
  const bf16* wrest;               // [C - c4, C]
  const bf16* wk;                  // [9, C - c4]
  bf16* xn;                        // [B, H, W, C], 16-byte aligned
  bf16* local;                     // [B, H, W, C], 16-byte aligned
  int B, H, W, c4;
  float slope, eps;
};

// Shared-memory layout (bytes from the start): gamma, beta (float32 [C]
// each), whm^T [C][LDH], wrest^T [C][LDR], the taps [9][KR * 16] (bf16;
// rest column j is channel (c4 & ~1) + j, zero outside [c4, C)), then
// nbuf staged tiles [SP][LDX] (bf16).
struct Layout {
  int KH, KR, LDH, LDR;
  size_t w_bytes, tile_elems;
  __host__ __device__ Layout(int C, int c4, int SP, int LDX) {
    KH = (c4 + 15) / 16;
    KR = (C - (c4 & ~1) + 15) / 16;
    LDH = KH * 16 + 8;
    LDR = KR * 16 + 8;
    w_bytes = 8 * (size_t)C + 2 * ((size_t)C * LDH + (size_t)C * LDR + 9 * (size_t)KR * 16);
    tile_elems = (size_t)SP * LDX;
  }
  __host__ __device__ size_t bytes(int nbuf) const { return w_bytes + 2 * nbuf * tile_elems; }
};

__device__ __forceinline__ void tile_origin(const Params& p, int TH, int tile, int& b, int& y0,
                                            int& x0) {
  const int tx = (p.W + kTW - 1) / kTW, ty = (p.H + TH - 1) / TH;
  b = tile / (tx * ty);
  const int r = tile % (tx * ty);
  y0 = (r / tx) * TH;
  x0 = (r % tx) * kTW;
}

// bf16 x of a tile and its halo -> the staged tile, 16 bytes a copy (pixels
// outside the image are left alone: the LayerNorm zeroes them)
template <int C>
__device__ __forceinline__ void copy_tile(const Params& p, bf16* xs, int b, int y0, int x0) {
  using Gm = Geo<C>;
  const bf16* x = static_cast<const bf16*>(p.x);
  for (int i = threadIdx.x; i < Gm::SP * (C / 8); i += kThreads) {
    const int q = i / (C / 8), part = i % (C / 8);
    const int gy = y0 - 1 + q / kSW, gx = x0 - 1 + q % kSW;
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
      lfsr::cp_async16(xs + q * Gm::LDX + part * 8,
                       x + (((size_t)b * p.H + gy) * p.W + gx) * C + part * 8);
  }
}

// 8 values of a pixel's channels c0..c0 + 7 as float
template <typename TX>
__device__ __forceinline__ void load8(const TX* src, float (&v)[8]);
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* src, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load8<float>(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 c = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

// LayerNorm of the staged tile's pixels into xs (bf16), zeros outside the
// image, and the tile's own pixels to p.xn. A group of G lanes takes a
// pixel, 8 channels a lane, kU pixels a group at once; bf16 x is read from
// xs (copied there by copy_tile), float32 x from global memory.
template <int C, typename TX>
__device__ __forceinline__ void layer_norm(const Params& p, bf16* xs, const float* s_g,
                                           const float* s_b, int b, int y0, int x0) {
  using Gm = Geo<C>;
  constexpr int G = Gm::G, NG = kThreads / G, kU = 2;
  constexpr bool kStagedX = std::is_same<TX, bf16>::value;
  const int gid = threadIdx.x / G, l = threadIdx.x % G;
  const bool act = 8 * l < C;
  const int c0 = act ? 8 * l : 0;
  for (int q0 = 0; q0 < Gm::SP; q0 += NG * kU) {  // uniform over the CTA: shuffles below
    float v[kU][8];
    bool in[kU];
    size_t pix[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * NG + gid;
      const int gy = y0 - 1 + q / kSW, gx = x0 - 1 + q % kSW;
      in[u] = q < Gm::SP && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      pix[u] = (((size_t)b * p.H + gy) * p.W + gx) * C;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
      if (in[u] && act) {
        if constexpr (kStagedX)
          load8<bf16>(xs + q * Gm::LDX + c0, v[u]);
        else
          load8<float>(static_cast<const float*>(p.x) + pix[u] + c0, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s += v[u][k];
        ss += v[u][k] * v[u][k];
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      const int q = q0 + u * NG + gid;
      if (q >= Gm::SP || !act) continue;
      const float mean = s / C;
      const float var = fmaxf(ss / C - mean * mean, 0.f);
      const float inv = rsqrtf(var + p.eps);
      uint4 r = make_uint4(0, 0, 0, 0);
      if (in[u]) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c0 + 2 * k;
          w[k] = lfsr::pack_bf16((v[u][2 * k] - mean) * (inv * s_g[c]) + s_b[c],
                                 (v[u][2 * k + 1] - mean) * (inv * s_g[c + 1]) + s_b[c + 1]);
        }
        r = make_uint4(w[0], w[1], w[2], w[3]);
        const int sy = q / kSW, sx = q % kSW;
        if (sy >= 1 && sy <= Gm::TH && sx >= 1 && sx <= kTW)
          *reinterpret_cast<uint4*>(p.xn + pix[u] + c0) = r;
      }
      *reinterpret_cast<uint4*>(xs + q * Gm::LDX + c0) = r;
    }
  }
}

// rest at output pixel (row r, column px) of the tile, channels ch, ch + 1:
// the 9 taps in (ky, kx) order, each product and each sum rounded to bf16
// (w: the taps of this column pair, stride ldw between taps)
template <int C>
__device__ __forceinline__ uint32_t taps(const bf16* xs, int r, int px, int ch, const bf16* w,
                                         int ldw) {
  if (ch >= C) return 0u;
  const bf16* src = xs + (r * kSW + px) * Geo<C>::LDX + ch;
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const bf16* v = src + ((k / 3) * kSW + k % 3) * Geo<C>::LDX;
    const uint32_t term = lfsr::mul_rn_bf16x2(lfsr::ld32(v), lfsr::ld32(w + k * ldw));
    acc = k == 0 ? term : lfsr::add_rn_bf16x2(acc, term);
  }
  return acc;
}

// y = round(round(h) + round(m)), lrelu'd and rounded, + xn, rounded: the
// twin's bf16 chain on one output value
__device__ __forceinline__ float local_value(float h, float m, float xn, float slope) {
  float y = lfsr::round_bf16(lfsr::round_bf16(h) + lfsr::round_bf16(m));
  if (!(y >= 0.f)) y = lfsr::round_bf16(slope * y);
  return y + xn;
}

template <int C, typename TX>
__global__ void __launch_bounds__(kThreads, 2) ln_msl_mma_kernel(const Params p) {
  using Gm = Geo<C>;
  constexpr int NT = Gm::NT, LDX = Gm::LDX;
  constexpr bool kStagedX = std::is_same<TX, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c4 = p.c4, c4e = c4 & ~1;
  const Layout lay(C, c4, Gm::SP, LDX);
  const int KH = lay.KH, KR = lay.KR, LDH = lay.LDH, LDR = lay.LDR, LDK = KR * 16;
  float* s_g = reinterpret_cast<float*>(smem);
  float* s_b = s_g + C;
  bf16* whmT = reinterpret_cast<bf16*>(s_b + C);  // [C][LDH]: k >= c4 zero
  bf16* wrT = whmT + C * LDH;                      // [C][LDR]: rest column j, zero outside
  bf16* wks = wrT + C * LDR;                       // [9][LDK]
  bf16* tiles[2] = {wks + 9 * LDK, wks + 9 * LDK + lay.tile_elems};

  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < C; i += kThreads) {
    s_g[i] = p.gamma[i];
    s_b[i] = p.beta[i];
  }
  for (int i = tid; i < C * LDH; i += kThreads) {
    const int n = i / LDH, k = i % LDH;
    whmT[i] = k < c4 ? p.whm[k * C + n] : zero;
  }
  for (int i = tid; i < C * LDR; i += kThreads) {
    const int n = i / LDR, ch = c4e + i % LDR;
    wrT[i] = ch >= c4 && ch < C ? p.wrest[(ch - c4) * C + n] : zero;
  }
  for (int i = tid; i < 9 * LDK; i += kThreads) {
    const int k = i / LDK, ch = c4e + i % LDK;
    wks[i] = ch >= c4 && ch < C ? p.wk[k * (C - c4) + ch - c4] : zero;
  }

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int tiles_n = p.B * ((p.H + Gm::TH - 1) / Gm::TH) * ((p.W + kTW - 1) / kTW);
  int b, y0, x0;
  if constexpr (kStagedX) {
    if ((int)blockIdx.x < tiles_n) {
      tile_origin(p, Gm::TH, blockIdx.x, b, y0, x0);
      copy_tile<C>(p, tiles[0], b, y0, x0);
    }
    lfsr::cp_async_commit();
  }
  int cur = 0;
  for (int tile = blockIdx.x; tile < tiles_n; tile += gridDim.x) {
    tile_origin(p, Gm::TH, tile, b, y0, x0);
    bf16* xs = tiles[cur];
    if constexpr (kStagedX) lfsr::cp_async_wait<0>();
    __syncthreads();  // x has landed (bf16); every warp is done with the last tile
    layer_norm<C, TX>(p, xs, s_g, s_b, b, y0, x0);
    __syncthreads();
    if constexpr (kStagedX) {  // the next tile's x flies while this one computes
      const int next = tile + gridDim.x;
      if (next < tiles_n) {
        int nb, ny, nx;
        tile_origin(p, Gm::TH, next, nb, ny, nx);
        copy_tile<C>(p, tiles[cur ^ 1], nb, ny, nx);
      }
      lfsr::cp_async_commit();
      cur ^= 1;
    }

#pragma unroll
    for (int mi = 0; mi < Gm::MT; ++mi) {
      const int r = warp + mi * kWarps;  // the m-tile: output row r, columns 0..15
      const bf16* row = xs + ((r + 1) * kSW + 1) * LDX;  // staged pixel (r + 1, 1)
      float ah[NT][4], ar[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[nt][e] = ar[nt][e] = 0.f;
      for (int ks = 0; ks < KH; ++ks) {  // head = xn[:, :16 KH] whm (zero rows past c4)
        uint32_t a[4];
        lfsr::ldmatrix_x4(a, row + (lane % 16) * LDX + ks * 16 + (lane / 16) * 8);
        lfsr::mma_bt(ah, a, whmT, LDH, ks * 16, lane);
      }
      for (int ks = 0; ks < KR; ++ks) {  // rest wrest, the A fragment from the taps
        const int j = ks * 16 + 2 * t;
        const uint32_t a[4] = {taps<C>(xs, r, g, c4e + j, wks + j, LDK),
                               taps<C>(xs, r, g + 8, c4e + j, wks + j, LDK),
                               taps<C>(xs, r, g, c4e + j + 8, wks + j + 8, LDK),
                               taps<C>(xs, r, g + 8, c4e + j + 8, wks + j + 8, LDK)};
        lfsr::mma_bt(ar, a, wrT, LDR, ks * 16, lane);
      }
      // epilogue: rows g (i 0) and g + 8 (i 1), columns 2t, 2t + 1 of each n-tile
      const int gy = y0 + r;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gx = x0 + g + 8 * i;
        const bool valid = gy < p.H && gx < p.W;
        bf16* dst = p.local + (((size_t)b * p.H + gy) * p.W + gx) * C;
        const bf16* xr = row + (g + 8 * i) * LDX + 2 * t;
        uint32_t w[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xr + nt * 8));
          w[nt] = lfsr::pack_bf16(local_value(ah[nt][2 * i], ar[nt][2 * i], xv.x, p.slope),
                                  local_value(ah[nt][2 * i + 1], ar[nt][2 * i + 1], xv.y, p.slope));
        }
#pragma unroll
        for (int n4 = 0; n4 + 4 <= NT; n4 += 4) {  // 16-byte granules: n-tile n4 + t
          uint32_t v[4] = {w[n4], w[n4 + 1], w[n4 + 2], w[n4 + 3]};
          lfsr::quad_transpose(v, t);
          if (valid)
            *reinterpret_cast<uint4*>(dst + (n4 + t) * 8) = make_uint4(v[0], v[1], v[2], v[3]);
        }
#pragma unroll
        for (int nt = NT / 4 * 4; nt < NT; ++nt)  // C % 32 == 16: the last two n-tiles
          if (valid) *reinterpret_cast<uint32_t*>(dst + nt * 8 + 2 * t) = w[nt];
      }
    }
  }
}

template <int C, typename TX>
cudaError_t launch_mma(const Params& p, cudaStream_t s) {
  using Gm = Geo<C>;
  constexpr bool kStagedX = std::is_same<TX, bf16>::value;
  const size_t smem = Layout(C, p.c4, Gm::SP, Gm::LDX).bytes(kStagedX ? 2 : 1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = ln_msl_mma_kernel<C, TX>;
  cudaError_t e = lfsr::set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles =
      (long long)p.B * ((p.H + Gm::TH - 1) / Gm::TH) * ((p.W + kTW - 1) / kTW);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_x(const Params& p, int x_dtype, cudaStream_t s) {
  if (x_dtype == lfsr::kBF16) return launch_mma<C, bf16>(p, s);
  if (x_dtype == lfsr::kF32) return launch_mma<C, float>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace mma

}  // namespace

// x [B, H, W, C] of x_dtype; gamma, beta [C] float32; whm [c4, C], wrest
// [C - c4, C], wk [3, 3, C - c4], xn and local of dtype (contiguous; x, xn
// and local 16-byte aligned). dtype float32 (x float32): "fma"; bfloat16 (x
// bfloat16, or float32 for the float32-input mode): "mma".
LFSR_EXPORT int lfsr_ln_msl(const void* x, const void* gamma, const void* beta, const void* whm,
                            const void* wrest, const void* wk, void* xn, void* local, int B,
                            int H, int W, int C, int c4, float slope, float eps, int x_dtype,
                            int dtype, void* stream) {
  if (C < kGroup || C > kMaxC || C % kGroup || c4 < 1 || c4 >= C || B < 1 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32 && x_dtype == lfsr::kF32)
    return launch_fma(x, gamma, beta, whm, wrest, wk, xn, local, B, H, W, C, c4, slope, eps, s);
  if (dtype != lfsr::kBF16) return cudaErrorInvalidValue;
  mma::Params p{};
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.whm = static_cast<const bf16*>(whm);
  p.wrest = static_cast<const bf16*>(wrest);
  p.wk = static_cast<const bf16*>(wk);
  p.xn = static_cast<bf16*>(xn);
  p.local = static_cast<bf16*>(local);
  p.B = B; p.H = H; p.W = W; p.c4 = c4; p.slope = slope; p.eps = eps;
  switch (C) {
    case 16: return mma::dispatch_x<16>(p, x_dtype, s);
    case 32: return mma::dispatch_x<32>(p, x_dtype, s);
    case 48: return mma::dispatch_x<48>(p, x_dtype, s);
    case 64: return mma::dispatch_x<64>(p, x_dtype, s);
    case 80: return mma::dispatch_x<80>(p, x_dtype, s);
    case 96: return mma::dispatch_x<96>(p, x_dtype, s);
    case 112: return mma::dispatch_x<112>(p, x_dtype, s);
    default: return mma::dispatch_x<128>(p, x_dtype, s);
  }
}
