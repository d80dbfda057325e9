// K6 — fused Swin-style window attention block.
//
// Replaces lfsr_tpu/ops/pallas_attention.py::_win_mha_kernel
// (window_mha_fused): for every ws x ws window of an [B, H, W, C] map,
//   ln  = LayerNorm(x)                      (centred two-pass variance)
//   q, k, v = ln @ Wqkv                     (q scaled by 1/sqrt(head_dim))
//   o_h = softmax(q_h k_h^T + bias_h) v_h   per head h
//   y   = x + attn_scale * (o @ Wout)
// All arithmetic is float32; x and y are float32 or bfloat16.
//
// Two kernels, chosen by shape (ops/window_attention.kernel_path):
//
// "mma" (window_mha_mma_kernel): ws 8, head_dim a multiple of 8, C <= 88,
// the flagship's shape (C 64, 4 heads of 16). What bounds it on this card:
// ~1.6 M multiply-adds a 64-token window against 32 KB of x and y (f32),
// ~50 FMA a byte: on the CUDA cores (67 TFLOP/s) the operations, on the
// tensor cores the bytes. Every product runs on the tensor cores as
// mma.sync m16n8k16 in bf16x3: a = a_hi + a_lo, two bf16 each, and lo.hi +
// hi.lo + hi.hi summed in float32, 16 of float32's 24 mantissa bits, ~2^-17
// a product. One TF32 product keeps about three decimal digits and misses
// the float32 check (1e-4 of scale) at attn_scale 1; 3xTF32 on m16n8k8
// holds it too but ran 1.5x slower (more products, each B fragment split
// in the loop; PERF.md). Design:
//  - Persistent CTAs, one an SM: Wqkv and Wout are split and staged once a
//    CTA, in fragment order (one 16-byte read a lane a B fragment: hi and lo
//    of both registers), and the CTA walks its windows, up to two at a time,
//    one a group of 4 warps; each group walks its own windows, so the groups
//    share only the weights.
//  - A warp owns 16 of its window's 64 tokens. It copies its rows of x by
//    cp.async; once its LayerNorm has read them, it issues the copy of its
//    rows of the group's next window, which is in flight through the rest
//    of this one. Only K and V, which every warp of the window reads, take
//    barriers (two a window, among the group's 128 threads).
//  - LN in registers (two lanes a row, both passes over shared memory). The
//    A operands ln, q, P and o never leave registers: two accumulator tiles
//    of 8 columns (row g: columns 2t, 2t + 1) are the A fragment of a
//    16-deep k-step as they stand. So S = q_h k_h^T, its bias and softmax (a
//    row's 64 scores on one quad: max and sum by two shuffles each) and
//    P v_h stay in registers. K and V go to shared memory split: K as
//    (hi, lo) of channel pairs, V of key pairs (the pair's other key is on
//    lane ^ 4), strides padded so every fragment read is free of bank
//    conflicts.
//  - y = x + attn_scale * (o Wout), x read back from global memory (L2),
//    staged over the warp's own K rows and stored in 16-byte granules.
//
// "fma" (window_mha_kernel), the other shapes (the dryrun's head_dim 4, the
// 72-wide V8 geometry's 18; C <= 80): one block per window, everything in
// shared memory, float32 CUDA-core FMAs; bounded by shared-memory bandwidth
// and occupancy (one ~149 KB block an SM).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 128;  // LayerNorm keeps C/32 <= 4 values per lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_mha_kernel(const T* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ wout, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, const float* __restrict__ bias,
                  const float* __restrict__ attn_scale, T* __restrict__ y, int H, int W, int C,
                  int ws, int heads, float qscale, float eps) {
  const int nt = ws * ws;     // tokens per window
  const int hd = C / heads;   // head dim
  const int ld = C + 1;       // padded row stride of [nt][C] tiles
  const int ldp = nt + 1;     // padded row stride of the score tile
  extern __shared__ float smem[];
  float* s_w = smem;                 // [C][3C]
  float* s_wo = s_w + 3 * C * C;     // [C][C]
  float* s_a = s_wo + C * C;         // [nt][ld]  LN output, then o
  float* s_q = s_a + nt * ld;        // [nt][ld]
  float* s_k = s_q + nt * ld;        // [nt][ld]
  float* s_v = s_k + nt * ld;        // [nt][ld]
  float* s_p = s_v + nt * ld;        // [nt][ldp] one head's scores / probabilities

  const int nww = W / ws, nwh = H / ws;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  auto pix = [&](int i) -> size_t {
    return (((size_t)b * H + wy * ws + i / ws) * W + wx * ws + i % ws) * C;
  };

  for (int i = tid; i < 3 * C * C; i += blockDim.x) s_w[i] = wqkv[i];
  for (int i = tid; i < C * C; i += blockDim.x) s_wo[i] = wout[i];

  // LayerNorm per token, one warp per token
  for (int i = warp; i < nt; i += nwarps) {
    const T* xr = x + pix(i);
    float v[kMaxC / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxC / 32; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < C ? lfsr::load(xr + c) : 0.f;
      s += v[j];
    }
    const float mu = lfsr::warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxC / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < C) q += (v[j] - mu) * (v[j] - mu);
    }
    const float inv = rsqrtf(lfsr::warp_sum(q) / C + eps);
#pragma unroll
    for (int j = 0; j < kMaxC / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < C) s_a[i * ld + c] = (v[j] - mu) * inv * ln_g[c] + ln_b[c];
    }
  }
  __syncthreads();

  // qkv projection
  const int C3 = 3 * C;
  for (int idx = tid; idx < nt * C3; idx += blockDim.x) {
    const int i = idx / C3, j = idx % C3;
    const float* a = s_a + i * ld;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc = fmaf(a[k], s_w[k * C3 + j], acc);
    if (j < C) s_q[i * ld + j] = acc * qscale;
    else if (j < 2 * C) s_k[i * ld + j - C] = acc;
    else s_v[i * ld + j - 2 * C] = acc;
  }
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    const int c0 = h * hd;
    for (int idx = tid; idx < nt * nt; idx += blockDim.x) {
      const int i = idx / nt, j = idx % nt;
      const float* qi = s_q + i * ld + c0;
      const float* kj = s_k + j * ld + c0;
      float acc = 0.f;
      for (int dd = 0; dd < hd; ++dd) acc = fmaf(qi[dd], kj[dd], acc);
      s_p[i * ldp + j] = acc + bias[(size_t)i * heads * nt + h * nt + j];
    }
    __syncthreads();
    for (int i = warp; i < nt; i += nwarps) {
      float* row = s_p + i * ldp;
      float m = -INFINITY;
      for (int j = lane; j < nt; j += 32) m = fmaxf(m, row[j]);
      m = lfsr::warp_max(m);
      float s = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        s += e;
      }
      s = lfsr::warp_sum(s);
      for (int j = lane; j < nt; j += 32) row[j] = row[j] / s;
    }
    __syncthreads();
    for (int idx = tid; idx < nt * hd; idx += blockDim.x) {
      const int i = idx / hd, dd = idx % hd;
      const float* pi = s_p + i * ldp;
      float acc = 0.f;
      for (int j = 0; j < nt; ++j) acc = fmaf(pi[j], s_v[j * ld + c0 + dd], acc);
      s_a[i * ld + c0 + dd] = acc;  // the LN tile is dead after the qkv projection
    }
    __syncthreads();
  }

  // output projection + scaled residual
  const float sc = *attn_scale;
  for (int idx = tid; idx < nt * C; idx += blockDim.x) {
    const int i = idx / C, c = idx % C;
    const float* o = s_a + i * ld;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc = fmaf(o[k], s_wo[k * C + c], acc);
    const size_t off = pix(i) + c;
    lfsr::store(y + off, lfsr::load(x + off) + acc * sc);
  }
}

size_t smem_bytes(int C, int nt) {
  return sizeof(float) * ((size_t)4 * C * C + (size_t)4 * nt * (C + 1) + (size_t)nt * (nt + 1));
}

template <typename T>
cudaError_t launch(const void* x, const void* wqkv, const void* wout, const void* ln_g,
                   const void* ln_b, const void* bias, const void* scale, void* y, int B, int H,
                   int W, int C, int ws, int heads, float qscale, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes(C, ws * ws);
  cudaError_t e = cudaFuncSetAttribute(window_mha_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long windows = (long)B * (H / ws) * (W / ws);
  window_mha_kernel<T><<<(unsigned)windows, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(wout), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<T*>(y), H, W, C, ws, heads, qscale, eps);
  return cudaGetLastError();
}

// ---- "mma": the tensor-core kernel ----------------------------------------

constexpr int kWinTokens = 64;      // ws 8
constexpr int kMmaMaxC = 88;        // the largest C whose plan fits (f32, one window a CTA)
constexpr int kGroupThreads = 128;  // a window: 4 warps of 16 tokens
constexpr int kMaxWindowsPerCta = 2;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

// Each instance's register arrays hold kNT 8-column tiles of C, so C <= 8
// kNT. A CTA holds at most kMaxWindowsPerCta windows at once: 8 warps of up
// to 255 registers (3 windows, 12 warps capped at 168, spilled and ran no
// faster: PERF.md).
__host__ __device__ constexpr int tiles_for(int C) { return C <= 32 ? 4 : C <= 64 ? 8 : 11; }

// words (4 bytes) >= ``words`` with stride % mod == r: the row strides that
// make the fragment reads free of bank conflicts
__host__ __device__ constexpr int pad_words(int words, int r, int mod) {
  return words + ((r - words) % mod + mod) % mod;
}

// Shared-memory plan of a CTA (bytes): Wqkv and Wout split for bf16x3 in
// fragment order, [ceil(C/16)][3C/8 or C/8][32 lanes] of uint4 {b0 hi, b1
// hi, b0 lo, b1 lo}; LN gamma and beta; then per window the x buffer
// [64][ldx] of T (a warp's 16 rows each), K as [64 keys][ldk] of uint2 {hi,
// lo} (each a bf16 pair of neighbouring channels) and V as [32 key pairs]
// [ldv] of uint2 {hi, lo} (each a bf16 pair of neighbouring keys). Strides
// in their elements: x's 8-byte float (4-byte bf16) reads of rows g and
// columns 2t need 8 mod 16 words (4 mod 8), the uint2 reads of K (rows g,
// pairs t) and V (rows t, columns g) 4 mod 16 uint2.
struct MmaPlan {
  int ldx, ldk, ldv;
  size_t wout, gamma, beta, groups, k, v, group_bytes;
  __host__ __device__ size_t bytes(int windows) const { return groups + windows * group_bytes; }
};

template <typename T>
__host__ __device__ MmaPlan mma_plan(int C) {
  MmaPlan p{};
  const int xw = C * (int)sizeof(T) / 4, ks = (C + 15) / 16;
  p.ldx = pad_words(xw, sizeof(T) == 4 ? 8 : 4, sizeof(T) == 4 ? 16 : 8) * 4 / (int)sizeof(T);
  p.ldk = pad_words(C / 2, 4, 16);
  p.ldv = pad_words(C, 4, 16);
  p.wout = (size_t)ks * (3 * C / 8) * 32 * 16;
  p.gamma = p.wout + (size_t)ks * (C / 8) * 32 * 16;
  p.beta = p.gamma + 4 * C;
  p.groups = p.beta + 4 * C;
  p.k = (size_t)kWinTokens * p.ldx * sizeof(T);
  p.v = p.k + (size_t)kWinTokens * p.ldk * 8;
  p.group_bytes = p.v + (size_t)(kWinTokens / 2) * p.ldv * 8;
  return p;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// two accumulator tiles (row g: columns 2t, 2t + 1; row g + 8: the same) of
// 8 columns each as the A fragment of a product over those 16 columns (the
// m16n8k16 layout), split for bf16x3
__device__ __forceinline__ void tiles_as_a(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  lfsr::split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  lfsr::split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  lfsr::split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  lfsr::split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// tile k + 1 of an array of n tiles, or k where there is none (a
// compile-time index; the caller zeroes what it reads there)
__host__ __device__ constexpr int up(int k, int n) { return k + 1 < n ? k + 1 : k; }

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// W [K, M] (row-major, float32) into fragment order for bf16x3: entry (ks, n,
// lane) holds b0 = (W[16ks + 2t][8n + g], W[16ks + 2t + 1][..]) and b1 = (rows
// + 8, + 9), hi and lo; rows past K are 0
__device__ __forceinline__ void stage_weights(uint4* dst, const float* __restrict__ w, int K,
                                              int M) {
  const int ks = (K + 15) / 16, nt = M / 8;
  for (int i = threadIdx.x; i < ks * nt * 32; i += blockDim.x) {
    const int l = i % 32, n = (i / 32) % nt, k0 = 16 * (i / (32 * nt)) + 2 * (l % 4);
    const int c = 8 * n + l / 4;
    auto at = [&](int r) { return r < K ? w[(size_t)r * M + c] : 0.f; };
    uint4 e;
    lfsr::split_bf16x2(at(k0), at(k0 + 1), e.x, e.z);
    lfsr::split_bf16x2(at(k0 + 8), at(k0 + 9), e.y, e.w);
    dst[i] = e;
  }
}

// grid: persistent CTAs; blockDim 128 x windows per CTA. kNT: 8-column tiles
// the register arrays hold (C <= 8 kNT)
template <typename T, int kNT>
__global__ void __launch_bounds__(kGroupThreads * kMaxWindowsPerCta, 1)
window_mha_mma_kernel(const T* __restrict__ x, const float* __restrict__ wqkv,
                      const float* __restrict__ wout, const float* __restrict__ ln_g,
                      const float* __restrict__ ln_b, const float* __restrict__ bias,
                      const float* __restrict__ attn_scale, T* __restrict__ y, int H, int W,
                      int C, int heads, int windows, float qscale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaPlan pl = mma_plan<T>(C);
  const int NT = C / 8, hd8 = C / heads / 8;
  const uint4* s_wqkv = reinterpret_cast<const uint4*>(smem_raw);
  const uint4* s_wout = reinterpret_cast<const uint4*>(smem_raw + pl.wout);
  float* s_g = reinterpret_cast<float*>(smem_raw + pl.gamma);
  float* s_b = reinterpret_cast<float*>(smem_raw + pl.beta);
  stage_weights(reinterpret_cast<uint4*>(smem_raw), wqkv, C, 3 * C);
  stage_weights(reinterpret_cast<uint4*>(smem_raw + pl.wout), wout, C, C);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    s_g[i] = ln_g[i];
    s_b[i] = ln_b[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 4, r0 = 16 * (warp % 4);  // the warp's first token
  const int g = lane / 4, t = lane % 4;
  unsigned char* gbase = smem_raw + pl.groups + grp * pl.group_bytes;
  T* const xs = reinterpret_cast<T*>(gbase);
  uint2* s_k = reinterpret_cast<uint2*>(gbase + pl.k);
  uint2* s_v = reinterpret_cast<uint2*>(gbase + pl.v);
  const float sc = *attn_scale;
  const int nww = W / 8, nwh = H / 8;
  const int slots = gridDim.x * (blockDim.x / kGroupThreads);
  constexpr int kPerGranule = 16 / sizeof(T);
  const int gpt = C / kPerGranule;  // 16-byte granules a token
  const int wq_n = 3 * NT;          // n-tiles of a Wqkv fragment row

  // global element offset of token i of window w
  auto pix = [&](int w, int i) -> size_t {
    const int b = w / (nwh * nww), wy = (w / nww) % nwh, wx = w % nww;
    return (((size_t)b * H + wy * 8 + i / 8) * W + wx * 8 + i % 8) * C;
  };
  // the warp's 16 rows of window w into xs, by cp.async (no wait)
  auto prefetch = [&](int w) {
    for (int i = lane; i < 16 * gpt; i += 32) {
      const int tok = r0 + i / gpt, k = (i % gpt) * kPerGranule;
      lfsr::cp_async16(xs + (size_t)tok * pl.ldx + k, x + pix(w, tok) + k);
    }
    lfsr::cp_async_commit();
  };

  int w = blockIdx.x * (blockDim.x / kGroupThreads) + grp;
  if (w < windows) prefetch(w);
  for (; w < windows; w += slots) {
    lfsr::cp_async_wait<0>();  // this window's rows have landed
    __syncwarp();

    // LayerNorm statistics: two lanes a row (row lane / 2), centred two-pass
    float mu, inv;
    {
      const T* xr = xs + (size_t)(r0 + lane / 2) * pl.ldx;
      float s = 0.f;
      for (int c = lane % 2; c < C; c += 2) s += lfsr::load(xr + c);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      mu = s / C;
      float q = 0.f;
      for (int c = lane % 2; c < C; c += 2) {
        const float d = lfsr::load(xr + c) - mu;
        q = fmaf(d, d, q);
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      inv = rsqrtf(q / C + eps);
    }
    const float mu0 = __shfl_sync(0xffffffffu, mu, 2 * g);
    const float inv0 = __shfl_sync(0xffffffffu, inv, 2 * g);
    const float mu1 = __shfl_sync(0xffffffffu, mu, 2 * g + 16);
    const float inv1 = __shfl_sync(0xffffffffu, inv, 2 * g + 16);
    // ln of the warp's rows as accumulator-shaped tiles (row g, columns
    // 8kk + 2t, + 1; row g + 8), the A operand of the projections
    float ln[kNT][4];
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      if (kk < NT) {
        const int c = 8 * kk + 2 * t;
        const float2 a = load2(xs + (size_t)(r0 + g) * pl.ldx + c);
        const float2 b = load2(xs + (size_t)(r0 + g + 8) * pl.ldx + c);
        const float2 gm = load2(s_g + c), bt = load2(s_b + c);
        ln[kk][0] = (a.x - mu0) * inv0 * gm.x + bt.x;
        ln[kk][1] = (a.y - mu0) * inv0 * gm.y + bt.y;
        ln[kk][2] = (b.x - mu1) * inv1 * gm.x + bt.x;
        ln[kk][3] = (b.y - mu1) * inv1 * gm.y + bt.y;
      } else {
        ln[kk][0] = ln[kk][1] = ln[kk][2] = ln[kk][3] = 0.f;
      }
    }
    __syncwarp();  // the rows are read: the next window's copy runs from here on
    if (w + slots < windows) prefetch(w + slots);

    // the projections, C columns at a time: q kept in registers, k and v to
    // shared memory split for bf16x3 (each warp its 16 rows)
    float qa[kNT][4];
#pragma unroll 1
    for (int part = 0; part < 3; ++part) {
      float acc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNT; kk += 2) {
        if (kk < NT) {
          uint32_t ah[4], al[4];
          tiles_as_a(ln[kk], ln[up(kk, kNT)], ah, al);  // ln is 0 past C
          const uint4* wf = s_wqkv + (kk / 2 * wq_n + part * NT) * 32 + lane;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            if (n < NT) {
              const uint4 b = wf[n * 32];
              lfsr::mma_3xbf16(acc[n], ah, al, b.x, b.y, b.z, b.w);
            }
          }
        }
      }
      if (part == 0) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[n][e] = acc[n][e] * qscale;
      } else if (part == 1) {  // K[key][channel pair]
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n < NT) {
            uint2 e0, e1;
            lfsr::split_bf16x2(acc[n][0], acc[n][1], e0.x, e0.y);
            lfsr::split_bf16x2(acc[n][2], acc[n][3], e1.x, e1.y);
            s_k[(r0 + g) * pl.ldk + 4 * n + t] = e0;
            s_k[(r0 + g + 8) * pl.ldk + 4 * n + t] = e1;
          }
        }
      } else {  // V[key pair][channel]: the pair's other key is on lane ^ 4
        const bool odd = g & 1;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n < NT) {
            const int c = 8 * n + 2 * t + odd;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float mine0 = acc[n][2 * half], mine1 = acc[n][2 * half + 1];
              const float got = __shfl_xor_sync(0xffffffffu, odd ? mine0 : mine1, 4);
              uint2 e;
              if (odd) lfsr::split_bf16x2(got, mine1, e.x, e.y);
              else lfsr::split_bf16x2(mine0, got, e.x, e.y);
              s_v[((r0 + g + 8 * half) / 2) * pl.ldv + c] = e;
            }
          }
        }
      }
    }
    named_barrier(1 + grp, kGroupThreads);  // the window's K and V are written

    float oa[kNT][4];  // o, by 8-column tiles of C
#pragma unroll 1
    for (int h = 0; h < heads; ++h) {
      const int n0 = h * hd8, n1 = n0 + hd8;  // the head's tiles
      float s[8][4];  // scores: 8 tiles of 8 keys
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n >= n0 && n < n1 && (n - n0) % 2 == 0) {  // k-step over channels 8n .. 8n + 15
          const bool pair = n + 1 < n1;  // else the step's upper half is 0
          float q1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) q1[e] = pair ? qa[up(n, kNT)][e] : 0.f;
          uint32_t ah[4], al[4];
          tiles_as_a(qa[n], q1, ah, al);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint2* kr = s_k + (8 * j + g) * pl.ldk + 4 * n + t;
            const uint2 b0 = kr[0], b1 = pair ? kr[4] : make_uint2(0u, 0u);
            lfsr::mma_3xbf16(s[j], ah, al, b0.x, b1.x, b0.y, b1.y);
          }
        }
      }
      // + bias, softmax over each row's 64 keys (one quad holds a row)
      const float* b0 = bias + (size_t)(r0 + g) * heads * kWinTokens + h * kWinTokens + 2 * t;
      const float* b1 = b0 + (size_t)8 * heads * kWinTokens;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(b0 + 8 * j));
        const float2 v = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j));
        s[j][0] += u.x; s[j][1] += u.y; s[j][2] += v.x; s[j][3] += v.y;
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      // exp(s - m) as 2^((s - m) log2 e) (ex2.approx: relative error ~2^-22)
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = lfsr::ex2((s[j][0] - m0) * kLog2e);
        s[j][1] = lfsr::ex2((s[j][1] - m0) * kLog2e);
        s[j][2] = lfsr::ex2((s[j][2] - m1) * kLog2e);
        s[j][3] = lfsr::ex2((s[j][3] - m1) * kLog2e);
        z0 += s[j][0] + s[j][1];
        z1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        z0 += __shfl_xor_sync(0xffffffffu, z0, o);
        z1 += __shfl_xor_sync(0xffffffffu, z1, o);
      }
      const float i0 = 1.f / z0, i1 = 1.f / z1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] *= i0; s[j][1] *= i0; s[j][2] *= i1; s[j][3] *= i1;
      }
      // o_h = P v_h: key tiles 2jj and 2jj + 1 are the A fragment of the
      // k-step over keys 16jj .. 16jj + 15
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        if (n >= n0 && n < n1) oa[n][0] = oa[n][1] = oa[n][2] = oa[n][3] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t ah[4], al[4];
        tiles_as_a(s[2 * jj], s[2 * jj + 1], ah, al);
        const uint2* vr = s_v + (8 * jj + t) * pl.ldv + g;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n >= n0 && n < n1) {
            const uint2 b0 = vr[8 * n], b1 = vr[4 * pl.ldv + 8 * n];
            lfsr::mma_3xbf16(oa[n], ah, al, b0.x, b1.x, b0.y, b1.y);
          }
        }
      }
    }
    named_barrier(1 + grp, kGroupThreads);  // every warp has read K and V

    // y = x + attn_scale * (o Wout), x read back from global memory (its
    // shared rows take the next window's copy by now)
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; kk += 2) {
      if (kk < NT) {
        float o1[4];  // the step's upper half, 0 past C
#pragma unroll
        for (int e = 0; e < 4; ++e) o1[e] = kk + 1 < NT ? oa[up(kk, kNT)][e] : 0.f;
        uint32_t ah[4], al[4];
        tiles_as_a(oa[kk], o1, ah, al);
        const uint4* wf = s_wout + (kk / 2 * NT) * 32 + lane;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n < NT) {
            const uint4 b = wf[n * 32];
            lfsr::mma_3xbf16(acc[n], ah, al, b.x, b.y, b.z, b.w);
          }
        }
      }
    }
    // y rows staged over the warp's own K rows (read by no warp after the
    // barrier above), then out in 16-byte granules
    const size_t p0 = pix(w, r0 + g) + 2 * t, p1 = pix(w, r0 + g + 8) + 2 * t;
    T* ys = reinterpret_cast<T*>(s_k + r0 * pl.ldk);
    const int ldy = pl.ldk * 8 / (int)sizeof(T);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < NT) {
        const float2 a = load2(x + p0 + 8 * n), b = load2(x + p1 + 8 * n);
        store2(ys + g * ldy + 8 * n + 2 * t, a.x + acc[n][0] * sc, a.y + acc[n][1] * sc);
        store2(ys + (g + 8) * ldy + 8 * n + 2 * t, b.x + acc[n][2] * sc, b.y + acc[n][3] * sc);
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * gpt; i += 32) {
      const int r = i / gpt, k = (i % gpt) * kPerGranule;
      *reinterpret_cast<int4*>(y + pix(w, r0 + r) + k) =
          *reinterpret_cast<const int4*>(ys + r * ldy + k);
    }
    __syncwarp();
  }
}

template <typename T, int kNT>
cudaError_t launch_mma(const void* x, const void* wqkv, const void* wout, const void* ln_g,
                       const void* ln_b, const void* bias, const void* scale, void* y, int B,
                       int H, int W, int C, int heads, float qscale, float eps, int ctas,
                       int per_cta, long long smem, cudaStream_t s) {
  // the caller's plan (ops/window_attention.mma_plan) must be this layout's
  if (per_cta < 1 || per_cta > kMaxWindowsPerCta || ctas < 1 ||
      smem != (long long)mma_plan<T>(C).bytes(per_cta) || smem > (long long)kSmemLimit)
    return cudaErrorInvalidValue;
  auto* kernel = window_mha_mma_kernel<T, kNT>;
  cudaError_t e = lfsr::set_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  const long windows = (long)B * (H / 8) * (W / 8);
  kernel<<<(unsigned)ctas, kGroupThreads * per_cta, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(wout), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<T*>(y), H, W, C, heads, (int)windows,
      qscale, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_by_width(const void* x, const void* wqkv, const void* wout,
                                const void* ln_g, const void* ln_b, const void* bias,
                                const void* scale, void* y, int B, int H, int W, int C,
                                int heads, float qscale, float eps, int ctas, int per_cta,
                                long long smem, cudaStream_t s) {
  switch (tiles_for(C)) {
    case 4: return launch_mma<T, 4>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C,
                                    heads, qscale, eps, ctas, per_cta, smem, s);
    case 8: return launch_mma<T, 8>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C,
                                    heads, qscale, eps, ctas, per_cta, smem, s);
    default: return launch_mma<T, 11>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C,
                                      heads, qscale, eps, ctas, per_cta, smem, s);
  }
}

}  // namespace

LFSR_EXPORT int lfsr_window_mha(const void* x, const void* wqkv, const void* wout,
                                const void* ln_g, const void* ln_b, const void* bias,
                                const void* scale, void* y, int B, int H, int W, int C, int ws,
                                int heads, float qscale, float eps, int dtype, void* stream) {
  if (C < 1 || C > kMaxC || ws < 1 || heads < 1 || C % heads || H % ws || W % ws)
    return cudaErrorInvalidValue;
  if (smem_bytes(C, ws * ws) > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return launch<float>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C, ws, heads,
                         qscale, eps, s);
  if (dtype == lfsr::kBF16)
    return launch<__nv_bfloat16>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C, ws,
                                 heads, qscale, eps, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel ("mma"): ws 8, head_dim = C / heads a multiple of
// 8, C <= 88; H and W multiples of 8; x, y and bias 16-byte aligned. ``ctas``
// persistent CTAs, each holding ``per_cta`` windows at a time in ``smem``
// bytes of shared memory: the plan of ops/window_attention.mma_plan, which
// must match this file's layout (mma_plan here) or the call is refused.
LFSR_EXPORT int lfsr_window_mha_mma(const void* x, const void* wqkv, const void* wout,
                                    const void* ln_g, const void* ln_b, const void* bias,
                                    const void* scale, void* y, int B, int H, int W, int C,
                                    int heads, float qscale, float eps, int ctas, int per_cta,
                                    long long smem, int dtype, void* stream) {
  if (B < 1 || C < 8 || C > kMmaMaxC || heads < 1 || C % heads || (C / heads) % 8 ||
      H % 8 || W % 8 || H < 8 || W < 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return launch_mma_by_width<float>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C,
                                      heads, qscale, eps, ctas, per_cta, smem, s);
  if (dtype == lfsr::kBF16)
    return launch_mma_by_width<__nv_bfloat16>(x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H,
                                              W, C, heads, qscale, eps, ctas, per_cta, smem, s);
  return cudaErrorInvalidValue;
}
