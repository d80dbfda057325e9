// K4 / K5 — the 4-way cross-scan permutation around the shared Mamba.
//
// Replace lfsr_tpu/ops/pallas_layout.py::_gather_kernel (cross_scan_gather)
// and ::_scatter_kernel (cross_scan_scatter). Channel quarter q of an
// [B, H, W, C] map is read in raster order q: 0 row-major, 1 reversed
// row-major, 2 column-major, 3 reversed column-major, into one [B, L, C]
// sequence (L = H*W).
//
// What bounds them on this card: both are data movement plus a little
// arithmetic. K4 moves 2 x 265 MB and K5 3 x 265 MB at the Synth
// whole-scene point ([4, 720, 720, 64] bfloat16): 0.16 and 0.24 ms of HBM
// time. K5's C x C mix is 17 GFLOP there, ~0.25 ms as float32 FMAs on the
// CUDA cores (with two shared-memory loads an FMA) and ~0.02 ms on the
// tensor cores.
// The TPU kernels spend their effort on relayouts (per-band BlockSpecs and
// anti-diagonal MXU matmuls to reverse rows, pallas_layout.py:69-80); on
// Hopper a permutation is index arithmetic on the load, and what costs is
// where the reads land: a run of raster pixels reads quarters 2 and 3 at
// positions H apart, a separate 32-byte piece each, and how many
// instructions the addresses take.
//  - K4 "tile" (a quarter a multiple of 8 bytes: bf16 C % 16 == 0, f32
//    C % 8 == 0; ops/cross_scan.gather_path): persistent CTAs walk tiles
//    of T consecutive output positions of one image (ops/cross_scan.
//    gather_tile: ~16 KB of rows, 128 at bf16 C 64), from both ends of
//    the image in turn, so the pieces of a pixel that positions l and
//    L - 1 - l read are fetched together. Each quarter's
//    pieces are copied by cp.async into a [position][C + C/4] tile in
//    shared memory, the permutation in the source addresses: quarter 0
//    reads a forward run of raster pixels, 1 a backward run, 2 and 3 runs
//    down columns, forwards and backwards; the pixel of a position comes
//    from one 32-bit multiply-high division by W or H (lfsr::FastDiv),
//    no 64-bit division anywhere. The next tile's copies are in flight
//    while this one normalises: P threads a position (8 at bf16 C 64),
//    one 16-byte shared read each, float32 sums and sums of squares
//    reduced by xor-shuffles, flax's fast variance, and each output row
//    written once, rounded once, in 16-byte granules of one contiguous
//    run. (The warp kernel before it: one warp a position, scalar 2-byte
//    loads, three 64-bit divisions a lane: bound by issue, 5.6x its byte
//    bound.)
//  - K4 "warp" (the other widths, bf16 C = 4, 12, ...): one warp per
//    sequence position; each lane reads its channels from the source
//    pixel of its quarter, then LayerNorm over C with warp reductions.
//  - K5 "mma" (bfloat16, C a multiple of 16): persistent CTAs (two an SM)
//    walk 2-D tiles of th x tw pixels (ops/cross_scan.scatter_tile: 16 x 16
//    up to 64 channels). A tile's un-permuted rows are copied by cp.async
//    from seq into a [pixel][C] bf16 tile in shared memory, the permutation
//    in the addresses: quarters 0 and 1 walk tile rows, 2 and 3 tile
//    columns, so every quarter reads runs of th or tw consecutive sequence
//    positions (backwards for 1 and 3); the next tile's copy is in flight
//    while this one computes. The mix runs on mma.sync m16n8k16 (bf16
//    operands, float32 sums, W staged once a CTA as W^T and read by
//    ldmatrix, two n-tiles a load), a warp 16 pixels of a tile row at a
//    time; y stays float32 and x + scale * y is rounded once, as the TPU
//    kernel does. x is read ahead of the mix and out written in
//    16-byte granules (a quad transpose of the accumulators).
//  - K5 "fma" (float32, or bfloat16 at other C): a block gathers kPix
//    consecutive output pixels' un-permuted rows into shared memory and
//    mixes them with W staged there as float32 on the CUDA cores.
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

// ---------------------------------------------------------------------------
// K5 "mma": bf16 on the tensor cores, 2-D tiles
// ---------------------------------------------------------------------------

namespace scatter_mma {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8, kThreads = 32 * kWarps;

struct Params {
  const bf16* seq;     // [B, H*W, C], 16-byte aligned
  const bf16* x;       // [B, H, W, C], 16-byte aligned
  const bf16* w;       // [C, C] (in, out)
  const float* scale;  // [1]
  bf16* out;           // [B, H, W, C], 16-byte aligned
  int B, H, W, th, tw;
};

// W^T [C][C + 8], then two z tiles of th rows of tw pixels [C + 8] and 8
// bf16 of padding a row (a tile column's pixels land on distinct banks)
__host__ __device__ inline size_t smem_bytes(int C, int th, int tw) {
  return 2 * ((size_t)C * (C + 8) + 2 * (size_t)th * (tw * (C + 8) + 8));
}

__device__ __forceinline__ void tile_origin(const Params& p, int tile, int& b, int& y0, int& x0) {
  const int tx = (p.W + p.tw - 1) / p.tw, ty = (p.H + p.th - 1) / p.th;
  b = tile / (tx * ty);
  const int r = tile % (tx * ty);
  y0 = (r / tx) * p.th;
  x0 = (r % tx) * p.tw;
}

// the tile's un-permuted seq rows -> z [py][px][C]: quarter q of pixel
// (hh, ww) is seq position seq_index(q, hh, ww); thread i takes copy i of
// a quarter, pixels along tile rows for q 0 and 1, along tile columns for
// q 2 and 3, so consecutive threads read consecutive positions
template <int C>
__device__ __forceinline__ void copy_tile(const Params& p, bf16* z, int b, int y0, int x0) {
  constexpr int g = C / 4, LDZ = C + 8;
  constexpr int kGran = (2 * g) % 16 == 0 ? 8 : 4;  // bf16 a copy: 16 or 8 bytes
  constexpr int nq = g / kGran;                     // copies a quarter of a pixel
  const int th = p.th, tw = p.tw, RS = tw * LDZ + 8;
  const long L = (long)p.H * p.W;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int i = threadIdx.x; i < th * tw * nq; i += kThreads) {
      const int part = i % nq, k = i / nq;
      const int py = q < 2 ? k / tw : k % th, px = q < 2 ? k % tw : k / th;
      const int hh = y0 + py, ww = x0 + px;
      if (hh >= p.H || ww >= p.W) continue;
      const bf16* src =
          p.seq + ((size_t)b * L + seq_index(q, hh, ww, p.H, p.W)) * C + q * g + part * kGran;
      bf16* dst = z + py * RS + px * LDZ + q * g + part * kGran;
      if constexpr (kGran == 8)
        lfsr::cp_async16(dst, src);
      else
        lfsr::cp_async8(dst, src);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2) scatter_mma_kernel(const Params p) {
  constexpr int NT = C / 8, KS = C / 16, LDZ = C + 8, LDW = C + 8, NG = NT / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wT = reinterpret_cast<bf16*>(smem);  // [C out][LDW]
  const int RS = p.tw * LDZ + 8;
  const size_t zelems = (size_t)p.th * RS;
  bf16* zbuf[2] = {wT + C * LDW, wT + C * LDW + zelems};
  for (int i = threadIdx.x; i < C * C; i += kThreads) wT[(i % C) * LDW + i / C] = p.w[i];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tiles = p.B * ((p.H + p.th - 1) / p.th) * ((p.W + p.tw - 1) / p.tw);
  const int mtiles = p.th * p.tw / 16, mpr = p.tw / 16;  // m-tiles a tile, a tile row
  const float sc = *p.scale;
  int b, y0, x0;
  if ((int)blockIdx.x < tiles) {
    tile_origin(p, blockIdx.x, b, y0, x0);
    copy_tile<C>(p, zbuf[0], b, y0, x0);
  }
  lfsr::cp_async_commit();
  int cur = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, cur ^= 1) {
    lfsr::cp_async_wait<0>();
    __syncthreads();  // z has landed; every warp is done with the other buffer
    const int next = tile + gridDim.x;
    if (next < tiles) {  // the next tile's rows fly while this one computes
      int nb, ny, nx;
      tile_origin(p, next, nb, ny, nx);
      copy_tile<C>(p, zbuf[cur ^ 1], nb, ny, nx);
    }
    lfsr::cp_async_commit();
    tile_origin(p, tile, b, y0, x0);
    const bf16* zs = zbuf[cur];
    for (int mi = warp; mi < mtiles; mi += kWarps) {
      const int py = mi / mpr, px0 = (mi % mpr) * 16, hh = y0 + py;
      // x of rows g (i 0) and g + 8 (i 1), read ahead of the mix: granule
      // j of a row is n-tile 4 j + t, as the quad transpose leaves y
      bool valid[2];
      size_t base[2];
      uint4 xv[2][NG > 0 ? NG : 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ww = x0 + px0 + g + 8 * i;
        valid[i] = hh < p.H && ww < p.W;
        base[i] = (((size_t)b * p.H + hh) * p.W + ww) * C;
#pragma unroll
        for (int j = 0; j < NG; ++j)
          xv[i][j] = valid[i] ? *reinterpret_cast<const uint4*>(p.x + base[i] + (4 * j + t) * 8)
                              : make_uint4(0, 0, 0, 0);
      }
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      const bf16* zr = zs + py * RS + px0 * LDZ;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        lfsr::ldmatrix_x4(a, zr + (lane % 16) * LDZ + ks * 16 + (lane / 16) * 8);
        lfsr::mma_bt(acc, a, wT, LDW, ks * 16, lane);
      }
      // out = x + scale * y in float32, rounded once
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          float lo[4], hi[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            lo[k] = acc[4 * j + k][2 * i];
            hi[k] = acc[4 * j + k][2 * i + 1];
          }
          lfsr::quad_transpose(lo, t);  // lane t: columns 2k, 2k + 1 of n-tile 4 j + t
          lfsr::quad_transpose(hi, t);
          const uint32_t xw[4] = {xv[i][j].x, xv[i][j].y, xv[i][j].z, xv[i][j].w};
          uint32_t o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[k]));
            o[k] = lfsr::pack_bf16(xf.x + sc * lo[k], xf.y + sc * hi[k]);
          }
          if (valid[i])
            *reinterpret_cast<uint4*>(p.out + base[i] + (4 * j + t) * 8) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
#pragma unroll
        for (int nt = NG * 4; nt < NT; ++nt) {  // C % 32 == 16: the last two n-tiles
          if (!valid[i]) continue;
          const size_t o = base[i] + nt * 8 + 2 * t;
          const float2 xf =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + o));
          *reinterpret_cast<uint32_t*>(p.out + o) =
              lfsr::pack_bf16(xf.x + sc * acc[nt][2 * i], xf.y + sc * acc[nt][2 * i + 1]);
        }
      }
    }
  }
}

template <int C>
cudaError_t launch(const Params& p, cudaStream_t s) {
  if (p.th < 1 || p.tw < 16 || p.tw % 16) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, p.th, p.tw);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = scatter_mma_kernel<C>;
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
      (long long)p.B * ((p.H + p.th - 1) / p.th) * ((p.W + p.tw - 1) / p.tw);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace scatter_mma

// ---------------------------------------------------------------------------
// K4 "tile": persistent CTAs, tiles of consecutive sequence positions
// ---------------------------------------------------------------------------

namespace gather_tile {

constexpr int kThreads = 256;

struct Params {
  const void* x;       // [B, H, W, C] (E), 16-byte aligned
  const float* gamma;  // [C]
  const float* beta;   // [C]
  void* out;           // [B, H*W, C] (E), 16-byte aligned
  int B, H, W, T;      // T: sequence positions a tile
  lfsr::FastDiv divH, divW;
  float eps;
};

// The layout of a width: a quarter is G elements (GB bytes), copied in
// granules of kGran bytes (16 where GB allows, else 8: the wrapper's rule
// ops/cross_scan.gather_path sends GB % 8 != 0 to the warp kernel), kVec
// elements a granule, NQ granules a quarter. A staged row is [C + G]: the
// pitch of 5 quarters (an odd number of quarter granules) spreads a warp's
// copies of consecutive positions over the banks. LayerNorm reads a row's
// N granules M at a time (M = 2 only above 32 granules: float32 with
// 8-byte quarters at C > 64), one thread a chunk of a group of P lanes (a
// power of two >= N / M).
template <typename E, int C>
struct Layout {
  static constexpr int G = C / 4, GB = G * (int)sizeof(E);
  static constexpr int kGran = GB % 16 == 0 ? 16 : 8, kVec = kGran / (int)sizeof(E);
  static constexpr int NQ = GB / kGran, LDS = C + G, N = 4 * NQ;
  static constexpr int M = N > 32 ? 2 : 1, kEl = M * kVec;  // granules, elements a thread
  static constexpr int P = N / M <= 4 ? 4 : N / M <= 8 ? 8 : N / M <= 16 ? 16 : 32;
  static constexpr int kRows = kThreads / P;  // rows a LayerNorm pass
  static_assert(GB % 8 == 0 && N % M == 0 && N / M <= 32, "the tile kernel's widths");
};

__device__ __forceinline__ void unpack(uint32_t w, float* v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  v[0] = f.x;
  v[1] = f.y;
}

// one granule of a staged row as kVec floats, and back into the output
template <int kVec>
__device__ __forceinline__ void load_gran(const __nv_bfloat16* s, float* v) {
  if constexpr (kVec == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(s);
    unpack(r.x, v); unpack(r.y, v + 2); unpack(r.z, v + 4); unpack(r.w, v + 6);
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(s);
    unpack(r.x, v); unpack(r.y, v + 2);
  }
}
template <int kVec>
__device__ __forceinline__ void load_gran(const float* s, float* v) {
  if constexpr (kVec == 4) {
    const float4 r = *reinterpret_cast<const float4*>(s);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else {
    const float2 r = *reinterpret_cast<const float2*>(s);
    v[0] = r.x; v[1] = r.y;
  }
}
template <int kVec>
__device__ __forceinline__ void store_gran(__nv_bfloat16* o, const float* v) {
  using lfsr::pack_bf16;
  if constexpr (kVec == 8)
    *reinterpret_cast<uint4*>(o) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  else
    *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}
template <int kVec>
__device__ __forceinline__ void store_gran(float* o, const float* v) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
}

// tile t -> its image b and first position l0 (tiles of T positions,
// ceil(L / T) an image). An image's tiles are walked from both ends in
// turn (0, last, 1, last - 1, ...): position l reads quarter 0 of pixel l
// and position L - 1 - l quarter 1 of the same pixel (2 and 3 likewise
// down the columns), so the tiles in flight together fetch two 32-byte
// pieces of each 128-byte pixel row at once, not one at a time.
__device__ __forceinline__ void tile_origin(const Params& p, int tile, int L, int& b, int& l0) {
  const int tpi = (L + p.T - 1) / p.T;
  b = tile / tpi;
  const int j = tile - b * tpi;
  l0 = ((j & 1) ? tpi - 1 - (j >> 1) : (j >> 1)) * p.T;
}

// The tile's positions l0 .. l0 + n - 1 -> s [position][LDS]: quarter q of
// position l is the pixel whose quarter-q sequence index is l (the
// permutation is an involution), raster index li = l (q 0, 2) or L - 1 - l
// (q 1, 3), row-major for q 0, 1 and column-major for q 2, 3. Copy i of a
// quarter is granule i % NQ of position i / NQ, so consecutive threads read
// a forward (q 0), backward (q 1) or column (q 2, 3) run of pixels.
template <typename E, int C>
__device__ __forceinline__ void copy_tile(const Params& p, E* s, int tile, int L) {
  using Y = Layout<E, C>;
  int b, l0;
  tile_origin(p, tile, L, b, l0);
  const int n = min(p.T, L - l0);
  const E* xb = static_cast<const E*>(p.x) + (size_t)b * L * C;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int i = threadIdx.x; i < n * Y::NQ; i += kThreads) {
      const int k = i / Y::NQ, part = i - k * Y::NQ;
      const int l = l0 + k, li = (q & 1) ? L - 1 - l : l;
      int hh, ww;
      if (q < 2) {
        hh = p.divW.div(li);
        ww = li - hh * p.W;
      } else {
        ww = p.divH.div(li);
        hh = li - ww * p.H;
      }
      const int c0 = q * Y::G + part * Y::kVec;
      const E* src = xb + ((size_t)hh * p.W + ww) * C + c0;
      E* dst = s + k * Y::LDS + c0;
      if constexpr (Y::kGran == 16)
        lfsr::cp_async16(dst, src);
      else
        lfsr::cp_async8(dst, src);
    }
  }
}

template <typename E, int C>
__global__ void __launch_bounds__(kThreads) gather_tile_kernel(const Params p) {
  using Y = Layout<E, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* const buf = reinterpret_cast<E*>(smem);  // two tiles of [T][LDS]
  const int tile_elems = p.T * Y::LDS;
  const int L = p.H * p.W;
  const int tiles = p.B * ((L + p.T - 1) / p.T);
  // this thread's chunk of a row, elements c0 .. c0 + kEl - 1 (the same at
  // every position), and its gamma and beta; lanes past the row hold zeros
  const int j = threadIdx.x % Y::P, row0 = threadIdx.x / Y::P, c0 = j * Y::kEl;
  const bool active = j < Y::N / Y::M;
  float ga[Y::kEl], be[Y::kEl];
#pragma unroll
  for (int e = 0; e < Y::kEl; ++e) {
    ga[e] = active ? p.gamma[c0 + e] : 0.f;
    be[e] = active ? p.beta[c0 + e] : 0.f;
  }
  if ((int)blockIdx.x < tiles) copy_tile<E, C>(p, buf, blockIdx.x, L);
  lfsr::cp_async_commit();
  int cur = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, cur ^= 1) {
    lfsr::cp_async_wait<0>();
    __syncthreads();  // this tile has landed; every thread is done with the other buffer
    if (tile + (int)gridDim.x < tiles)  // the next tile's rows fly while this one normalises
      copy_tile<E, C>(p, buf + (cur ^ 1) * tile_elems, tile + gridDim.x, L);
    lfsr::cp_async_commit();
    int b, l0;
    tile_origin(p, tile, L, b, l0);
    const E* s = buf + cur * tile_elems;
    E* ob = static_cast<E*>(p.out) + ((size_t)b * L + l0) * C;
    // every thread runs T / kRows passes (T is a multiple of kRows), so
    // the group's shuffles are warp-uniform
    for (int r = row0; r < p.T; r += Y::kRows) {
      float v[Y::kEl];
      float s1 = 0.f, s2 = 0.f;
      if (active) {
#pragma unroll
        for (int m = 0; m < Y::M; ++m)
          load_gran<Y::kVec>(s + r * Y::LDS + c0 + m * Y::kVec, v + m * Y::kVec);
#pragma unroll
        for (int e = 0; e < Y::kEl; ++e) {
          s1 += v[e];
          s2 += v[e] * v[e];
        }
      }
#pragma unroll
      for (int o = Y::P / 2; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      // flax's fast variance, float32 statistics, rounded once at the store
      const float mean = s1 / C;
      const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + p.eps);
      if (active && l0 + r < L) {
#pragma unroll
        for (int e = 0; e < Y::kEl; ++e) v[e] = (v[e] - mean) * inv * ga[e] + be[e];
#pragma unroll
        for (int m = 0; m < Y::M; ++m)
          store_gran<Y::kVec>(ob + (size_t)r * C + c0 + m * Y::kVec, v + m * Y::kVec);
      }
    }
  }
}

template <typename E, int C>
cudaError_t launch(const Params& p, cudaStream_t s) {
  using Y = Layout<E, C>;
  if (p.T < Y::kRows || p.T % Y::kRows) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)p.T * Y::LDS * sizeof(E);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = gather_tile_kernel<E, C>;
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
  const long long L = (long long)p.H * p.W;
  const long long tiles = (long long)p.B * ((L + p.T - 1) / p.T);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// the widths the tile kernel takes: C a multiple of 32 / sizeof(E) (a
// quarter of a multiple of 8 bytes) up to kMaxC
template <typename E, int C = kMaxC>
cudaError_t dispatch(int c, const Params& p, cudaStream_t s) {
  constexpr int kStep = 32 / (int)sizeof(E);
  if (c == C) return launch<E, C>(p, s);
  if constexpr (C > kStep) return dispatch<E, C - kStep>(c, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace gather_tile

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

// x [B, H, W, C] and out [B, H*W, C] of ``dtype`` (contiguous, 16-byte
// aligned), gamma and beta [C] float32; tiles of T positions
// (ops/cross_scan.gather_tile), C a multiple of 16 (bf16) or 8 (f32).
LFSR_EXPORT int lfsr_cross_scan_gather_tile(const void* x, const void* gamma, const void* beta,
                                            void* out, int B, int H, int W, int C, int T,
                                            float eps, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)H * W >= (1ll << 31)) return cudaErrorInvalidValue;
  gather_tile::Params p{};
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = out;
  p.B = B; p.H = H; p.W = W; p.T = T;
  p.divH = lfsr::FastDiv(H);
  p.divW = lfsr::FastDiv(W);
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return gather_tile::dispatch<float>(C, p, s);
  if (dtype == lfsr::kBF16) return gather_tile::dispatch<__nv_bfloat16>(C, p, s);
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

// seq [B, H*W, C], x and out [B, H, W, C], w [C, C], all bfloat16 and
// contiguous (seq, x, out 16-byte aligned); scale [1] float32. Tiles of th
// x tw pixels (tw a multiple of 16; ops/cross_scan.scatter_tile).
LFSR_EXPORT int lfsr_cross_scan_scatter_mma(const void* seq, const void* x, const void* w,
                                            const void* scale, void* out, int B, int H, int W,
                                            int C, int th, int tw, void* stream) {
  if (B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  scatter_mma::Params p{};
  p.seq = static_cast<const __nv_bfloat16*>(seq);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.W = W; p.th = th; p.tw = tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return scatter_mma::launch<16>(p, s);
    case 32: return scatter_mma::launch<32>(p, s);
    case 48: return scatter_mma::launch<48>(p, s);
    case 64: return scatter_mma::launch<64>(p, s);
    case 80: return scatter_mma::launch<80>(p, s);
    case 96: return scatter_mma::launch<96>(p, s);
    case 112: return scatter_mma::launch<112>(p, s);
    case 128: return scatter_mma::launch<128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
