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
// positions H apart, a separate 32-byte piece each.
//  - K4: one warp per sequence position; each lane reads its channels from
//    the source pixel of its quarter, then LayerNorm over C with warp
//    reductions (flax fast-variance form, eps from the caller).
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
