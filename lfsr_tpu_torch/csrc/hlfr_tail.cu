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
// Design: nothing of z or t reaches HBM. A CTA owns a tile of output
// pixels and stages its halo of y one pixel wider on each side (zeros
// outside the image: z has no bias and lrelu(0) = 0, so zero y is
// zero-padded z) in shared memory, with w1 and W36 transposed there once
// per CTA (persistent CTAs walk the tiles). The halo's product costs more
// than the tile's; the wider the tile, the less.
//  - bfloat16 (tail_mma_kernel): tiles of 16 x 30 output pixels, an 18 x
//    32 halo of 576 pixels = 36 m-tiles of 16, 12 warps of 3 m-tiles (1.20x
//    the tile's work). One CTA an SM: w1^T (36,864 B at C 64, Cz 256),
//    W36^T (21,120 B) and two halo buffers (2 x 82,944 B) of the 232,448
//    a block may use. The halo is copied by cp.async in 16-byte pieces
//    (zero-filled outside the image), the next tile's while this one
//    computes. A warp holds its 3 m-tiles' A fragments of y in registers
//    and walks z 16 channels at a time, the outer loop: the B fragments
//    of w1^T and of W36^T are read by ldmatrix once per 16 channels and
//    serve all 3 m-tiles, whose z -> lrelu -> W36 chains are independent.
//    z [16, 16] per m-tile by mma.sync m16n8k16 (bf16 in, f32 sums over
//    the C channels in order); rounded, lrelu'd and packed in registers,
//    the accumulator fragment of z is the A fragment of the next product
//    (as FlashAttention's P.V), t [16, 40] += z . W36 (5 n-tiles, 36
//    columns used; z's channels in order). t stays in registers until
//    all warps are done with the halo; then it goes to shared memory over
//    it (576 x 36 float32 = the buffer's 82,944 B at C 64). Each output's
//    sums run in the order the 16 x 16 kernel before it used, so the
//    output is that kernel's bit for bit.
//  - float32 (tail_f32_kernel, the reference's float32 checks): tiles of
//    16 x 16 with an 18 x 18 halo, one halo pixel per thread on the CUDA
//    cores, y's C values and t's 36 sums in registers, w1 and W36 read as
//    broadcasts from shared memory.
//  The nine shifted adds read t out of shared memory, in the reference's
//  order (bias, then k = 0..8), one (pixel, j) per thread.
// Shapes the wrapper checks: C in {16, 32, 48, 64}, Cz a multiple of 16,
// rr = 4 (the last pixel-shuffle stage of r = 2, scales 2 and 4); the
// tile it passes must be the kernel's (ops/head.TAIL_TILES).
#include "common.cuh"


namespace {

using bf16 = __nv_bfloat16;
using lfsr::mma_bf16;

constexpr int kRR = 4;                // output channels (r * r)
constexpr int kTaps = 9 * kRR;        // 36 columns of W36
constexpr int kNT = (kTaps + 7) / 8;  // 5 n-tiles of W36's columns

// a tile of TH x TW output pixels and its halo of (TH + 2) x (TW + 2)
template <int TH, int TW>
struct Tile {
  static constexpr int kTH = TH, kTW = TW, kHW = TW + 2, kHalo = (TH + 2) * (TW + 2);
};
using MmaTile = Tile<16, 30>;  // tail_mma_kernel: 18 x 32 = 576 halo pixels
using F32Tile = Tile<16, 16>;  // tail_f32_kernel: 18 x 18 = 324

constexpr int kMmaWarps = 12;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMPerWarp = MmaTile::kHalo / 16 / kMmaWarps;  // 3 m-tiles of 16 halo pixels
constexpr int kF32Threads = 352;                            // >= F32Tile::kHalo, whole warps

static_assert(MmaTile::kHalo % 16 == 0 && MmaTile::kHalo / 16 == kMmaWarps * kMPerWarp,
              "the halo's m-tiles split evenly over the warps");
static_assert(kF32Threads >= F32Tile::kHalo, "a thread per halo pixel");

struct TailParams {
  const void* y;      // [B, H, W, C] (T), 16-byte aligned
  const void* w1;     // [C, Cz] (T)
  const void* w36;    // [Cz, kTaps] (T)
  const float* bias;  // [1]
  float* out;         // [B, H, W, kRR], 16-byte aligned
  int B, H, W, Cz;
  float slope;
};

template <class Tl>
__device__ __forceinline__ int tile_count(const TailParams& p) {
  return p.B * ((p.H + Tl::kTH - 1) / Tl::kTH) * ((p.W + Tl::kTW - 1) / Tl::kTW);
}

// tile -> (image, first output row, first output column), row-major over
// the image's tiles
template <class Tl>
__device__ __forceinline__ void tile_origin(const TailParams& p, int tile, int& b, int& y0,
                                            int& x0) {
  const int tx = (p.W + Tl::kTW - 1) / Tl::kTW, ty = (p.H + Tl::kTH - 1) / Tl::kTH;
  b = tile / (tx * ty);
  const int r = tile - b * (tx * ty), ry = r / tx;
  y0 = ry * Tl::kTH;
  x0 = (r - ry * tx) * Tl::kTW;
}

// out = bias + the nine shifted taps of t_s [halo pixel][kTaps], one
// output pixel per thread: its kRR = 4 sums as a float4, each tap's four
// columns one 16-byte read (row pitch 144 bytes: conflict-free), k in the
// reference's order
template <class Tl>
__device__ __forceinline__ void shifted_adds(const TailParams& p, const float* t_s, int b, int y0,
                                             int x0) {
  static_assert(kRR == 4, "a pixel's outputs are one float4");
  const float bias = p.bias[0];
  for (int px = threadIdx.x; px < Tl::kTH * Tl::kTW; px += blockDim.x) {
    const int oy = px / Tl::kTW, ox = px - oy * Tl::kTW;
    if (y0 + oy >= p.H || x0 + ox >= p.W) continue;
    float4 v = make_float4(bias, bias, bias, bias);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 t = *reinterpret_cast<const float4*>(
            t_s + ((oy + ky) * Tl::kHW + ox + kx) * kTaps + (ky * 3 + kx) * kRR);
        v.x += t.x;
        v.y += t.y;
        v.z += t.z;
        v.w += t.w;
      }
    *reinterpret_cast<float4*>(p.out + (((size_t)b * p.H + y0 + oy) * p.W + x0 + ox) * kRR) = v;
  }
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores
// --------------------------------------------------------------------------

// lrelu of two z sums, each rounded to bf16 first and the product again
// (torch's where(z >= 0, z, slope * z) on a bf16 z), packed low-first.
// Each rounding is one cvt.rn.bf16x2 for both sums and the choice is
// integer: the float conversions' pipe, not the tensor cores, bounded the
// kernel when each value took its own cvt there and back (16 a clock on
// an SM). A z of -0 takes slope * -0 = -0: the same bits.
__device__ __forceinline__ uint32_t lrelu_pack(float lo, float hi, float slope) {
  const uint32_t zb = lfsr::pack_bf16(lo, hi);
  const float zlo = __uint_as_float(zb << 16), zhi = __uint_as_float(zb & 0xffff0000u);
  const uint32_t mb = lfsr::pack_bf16(slope * zlo, slope * zhi);
  const uint32_t neg = ((zb >> 15) & 0x00010001u) * 0xffffu;  // the halves with the sign set
  return (zb & ~neg) | (mb & neg);
}

// a halo buffer: y [kHalo][C + 8] bf16, then t [kHalo][kTaps] float32 over it
__host__ __device__ constexpr size_t mma_buf_bytes(int C) {
  return (size_t)MmaTile::kHalo * (C + 8) * 2 > (size_t)MmaTile::kHalo * kTaps * 4
             ? (size_t)MmaTile::kHalo * (C + 8) * 2
             : (size_t)MmaTile::kHalo * kTaps * 4;
}

// w1^T [Cz][C + 8], W36^T [kNT * 8][Cz + 8] and two halo buffers
size_t mma_smem(int C, int Cz) {
  return (size_t)Cz * (C + 8) * 2 + (size_t)kNT * 8 * (Cz + 8) * 2 + 2 * mma_buf_bytes(C);
}

// the tile's halo of y -> ys [halo pixel][C + 8] by cp.async, 16 bytes a
// copy; pixels outside the image are zero-filled
template <int C>
__device__ __forceinline__ void copy_halo(const TailParams& p, int tile, bf16* ys) {
  using Tl = MmaTile;
  constexpr int kParts = C / 8, LDY = C + 8;
  int b, y0, x0;
  tile_origin<Tl>(p, tile, b, y0, x0);
  const bf16* yg = static_cast<const bf16*>(p.y);
  for (int i = threadIdx.x; i < Tl::kHalo * kParts; i += kMmaThreads) {
    const int hp = i / kParts, part = i - hp * kParts;
    const int gy = y0 - 1 + hp / Tl::kHW, gx = x0 - 1 + hp % Tl::kHW;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const bf16* src = inside ? yg + (((size_t)b * p.H + gy) * p.W + gx) * C + part * 8 : yg;
    lfsr::cp_async16_zfill(ys + hp * LDY + part * 8, src, inside);
  }
}

template <int C>
__global__ void __launch_bounds__(kMmaThreads, 1) tail_mma_kernel(const TailParams p) {
  constexpr int LDY = C + 8;  // bf16 per staged row of y and of w1^T: conflict-free fragments
  constexpr int KS = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cz = p.Cz, LDZ = Cz + 8;
  bf16* w1t = reinterpret_cast<bf16*>(smem);  // [Cz][LDY]
  bf16* w36t = w1t + (size_t)Cz * LDY;        // [kNT * 8][LDZ]
  unsigned char* bufs = reinterpret_cast<unsigned char*>(w36t + (size_t)kNT * 8 * LDZ);
  // halo buffer i (0 or 1)
  auto ybuf = [&](int i) { return reinterpret_cast<bf16*>(bufs + i * mma_buf_bytes(C)); };

  const int tiles = tile_count<MmaTile>(p);
  if ((int)blockIdx.x < tiles) copy_halo<C>(p, blockIdx.x, ybuf(0));
  lfsr::cp_async_commit();
  const bf16* w1 = static_cast<const bf16*>(p.w1);
  const bf16* w36 = static_cast<const bf16*>(p.w36);
  for (int i = threadIdx.x; i < C * Cz; i += blockDim.x)
    w1t[(i % Cz) * LDY + i / Cz] = w1[i];
  for (int i = threadIdx.x; i < kNT * 8 * Cz; i += blockDim.x) {
    const int n = i / Cz, k = i % Cz;
    w36t[n * LDZ + k] = n < kTaps ? w36[(size_t)k * kTaps + n] : __float2bfloat16_rn(0.f);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // lane l's row of a B-fragment ldmatrix (as lfsr::mma_bt): row l % 8 of
  // n-tile half l / 16, k half (l / 8) % 2; two n-tiles a load
  const int brow = ((lane >> 4) << 3) + (lane & 7), bk = ((lane >> 3) & 1) * 8;
  int cur = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, cur ^= 1) {
    lfsr::cp_async_wait<0>();
    __syncthreads();  // the halo has landed, the weights are staged; the other buffer's t is read
    if (tile + (int)gridDim.x < tiles)  // the next tile's halo flies while this one computes
      copy_halo<C>(p, tile + gridDim.x, ybuf(cur ^ 1));
    lfsr::cp_async_commit();

    const bf16* ys = ybuf(cur);
    // the A fragments of y for this warp's m-tiles (rows m0 + lane % 16,
    // columns ks * 16 + (lane / 16) * 8), held for the whole tile
    uint32_t a[kMPerWarp][KS][4];
#pragma unroll
    for (int mi = 0; mi < kMPerWarp; ++mi)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        lfsr::ldmatrix_x4(a[mi][ks], ys + ((warp + mi * kMmaWarps) * 16 + lane % 16) * LDY +
                                         ks * 16 + (lane / 16) * 8);
    float acc[kMPerWarp][kNT][4];
#pragma unroll
    for (int mi = 0; mi < kMPerWarp; ++mi)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][nt][c] = 0.f;

    for (int zs = 0; zs < Cz; zs += 16) {
      // w1^T's B fragments for z channels zs .. zs + 15 (n-tiles h = 0, 1),
      // every k step, shared by the warp's m-tiles
      uint32_t bw[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        lfsr::ldmatrix_x4(bw[ks], w1t + (zs + brow) * LDY + ks * 16 + bk);
      // z = round(y . w1), lrelu'd: the accumulators of z's two n-tiles are
      // the A fragment over its 16 channels
      uint32_t za[kMPerWarp][4];
#pragma unroll
      for (int mi = 0; mi < kMPerWarp; ++mi) {
        float z[2][4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_bf16(z[h], a[mi][ks], bw[ks][2 * h], bw[ks][2 * h + 1]);
        za[mi][0] = lrelu_pack(z[0][0], z[0][1], p.slope);
        za[mi][1] = lrelu_pack(z[0][2], z[0][3], p.slope);
        za[mi][2] = lrelu_pack(z[1][0], z[1][1], p.slope);
        za[mi][3] = lrelu_pack(z[1][2], z[1][3], p.slope);
      }
      // W36^T's B fragments at k = zs .. zs + 15: n-tiles (0, 1), (2, 3), 4
      uint32_t b01[4], b23[4], b4[2];
      lfsr::ldmatrix_x4(b01, w36t + brow * LDZ + zs + bk);
      lfsr::ldmatrix_x4(b23, w36t + (16 + brow) * LDZ + zs + bk);
      lfsr::ldmatrix_x2(b4, w36t + (32 + (lane & 7)) * LDZ + zs + bk);
#pragma unroll
      for (int mi = 0; mi < kMPerWarp; ++mi) {
        mma_bf16(acc[mi][0], za[mi], b01[0], b01[1]);
        mma_bf16(acc[mi][1], za[mi], b01[2], b01[3]);
        mma_bf16(acc[mi][2], za[mi], b23[0], b23[1]);
        mma_bf16(acc[mi][3], za[mi], b23[2], b23[3]);
        mma_bf16(acc[mi][4], za[mi], b4[0], b4[1]);
      }
    }
    __syncthreads();  // every warp is done with the halo: t overwrites it
    float* t_s = reinterpret_cast<float*>(ybuf(cur));  // [kHalo][kTaps]
#pragma unroll
    for (int mi = 0; mi < kMPerWarp; ++mi) {
      const int m0 = (warp + mi * kMmaWarps) * 16;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < kTaps) {
          *reinterpret_cast<float2*>(t_s + (m0 + g) * kTaps + col) =
              make_float2(acc[mi][nt][0], acc[mi][nt][1]);
          *reinterpret_cast<float2*>(t_s + (m0 + g + 8) * kTaps + col) =
              make_float2(acc[mi][nt][2], acc[mi][nt][3]);
        }
      }
    }
    __syncthreads();
    int b, y0, x0;
    tile_origin<MmaTile>(p, tile, b, y0, x0);
    shifted_adds<MmaTile>(p, t_s, b, y0, x0);
  }
}

// --------------------------------------------------------------------------
// float32: CUDA cores
// --------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kF32Threads) tail_f32_kernel(const TailParams p) {
  using Tl = F32Tile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cz = p.Cz;
  float* w1t = reinterpret_cast<float*>(smem);  // [Cz][C]
  float* w36s = w1t + (size_t)Cz * C;           // [Cz][kTaps]
  float* t_s = w36s + (size_t)Cz * kTaps;       // [kHalo][kTaps]
  const float* w1 = static_cast<const float*>(p.w1);
  for (int i = threadIdx.x; i < C * Cz; i += blockDim.x) w1t[(i % Cz) * C + i / Cz] = w1[i];
  for (int i = threadIdx.x; i < Cz * kTaps; i += blockDim.x)
    w36s[i] = static_cast<const float*>(p.w36)[i];

  const int hp = threadIdx.x;  // this thread's halo pixel
  const int tiles = tile_count<Tl>(p);
  const float* yg = static_cast<const float*>(p.y);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, y0, x0;
    tile_origin<Tl>(p, tile, b, y0, x0);
    __syncthreads();  // the weights are staged; the last tile's t_s is read
    if (hp < Tl::kHalo) {
      const int gy = y0 - 1 + hp / Tl::kHW, gx = x0 - 1 + hp % Tl::kHW;
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
    shifted_adds<Tl>(p, t_s, b, y0, x0);
  }
}

size_t f32_smem(int C, int Cz) {
  return sizeof(float) * ((size_t)Cz * C + (size_t)Cz * kTaps + (size_t)F32Tile::kHalo * kTaps);
}

// one persistent CTA per resident slot, at most one per tile
template <class Tl, typename Kernel>
cudaError_t launch_tail(Kernel kernel, int threads, size_t smem, const TailParams& p,
                        cudaStream_t stream) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
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
  const long long tiles = (long long)p.B * ((p.H + Tl::kTH - 1) / Tl::kTH) *
                          ((p.W + Tl::kTW - 1) / Tl::kTW);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the kernel of a dtype, if (th, tw) is its tile
template <int C>
cudaError_t dispatch_tail(const TailParams& p, int dtype, int th, int tw, cudaStream_t s) {
  if (dtype == lfsr::kBF16 && th == MmaTile::kTH && tw == MmaTile::kTW)
    return launch_tail<MmaTile>(tail_mma_kernel<C>, kMmaThreads, mma_smem(C, p.Cz), p, s);
  if (dtype == lfsr::kF32 && th == F32Tile::kTH && tw == F32Tile::kTW)
    return launch_tail<F32Tile>(tail_f32_kernel<C>, kF32Threads, f32_smem(C, p.Cz), p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// y [B, H, W, C], w1 [C, Cz] and w36 [Cz, 36] of ``dtype`` (contiguous, y
// and out 16-byte aligned); bias [1] and out [B, H, W, 4] float32; (th,
// tw) the output tile of the dtype's kernel (16 x 30 bf16, 16 x 16 float32).
LFSR_EXPORT int lfsr_hlfr_tail(const void* y, const void* w1, const void* w36, const void* bias,
                               void* out, int B, int H, int W, int C, int Cz, int th, int tw,
                               float slope, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cz < 16 || Cz % 16 != 0) return cudaErrorInvalidValue;
  TailParams p{};
  p.y = y; p.w1 = w1; p.w36 = w36;
  p.bias = static_cast<const float*>(bias); p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.Cz = Cz; p.slope = slope;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return dispatch_tail<16>(p, dtype, th, tw, s);
    case 32: return dispatch_tail<32>(p, dtype, th, tw, s);
    case 48: return dispatch_tail<48>(p, dtype, th, tw, s);
    case 64: return dispatch_tail<64>(p, dtype, th, tw, s);
    default: return cudaErrorInvalidValue;
  }
}
