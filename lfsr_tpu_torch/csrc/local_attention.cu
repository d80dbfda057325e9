// K12 — banded (local-window) multi-head attention over a token grid (LFT's
// SpaTrans).
//
// Replaces no TPU kernel: JAX runs lfsr_tpu/ops/local_attention.py::
// local_window_mha as XLA ops (25 shifted products, a stack, a masked softmax
// and 25 shifted multiply-adds). For q, k, v [B, h*w, D] (token (i, j) at
// row i * w + j, channel-contiguous heads of hd = D / heads channels) and a
// k_r x k_c window, token (i, j) attends to (i + di, j + dj) for di in
// [-(k_r/2), k_r - k_r/2), dj likewise, slots outside the image taking
// exactly zero weight:
//   o_h(i, j) = softmax_{di, dj}(q_h(i, j) . k_h(i + di, j + dj) / sqrt(hd))
//               . v_h(i + di, j + dj)                    (float32 math)
// stored in the I/O dtype. Two kernels, chosen by the wrapper from the dtype
// (ops/local_attention.py::kernel_path):
//
// bfloat16: local_mha_mma_kernel, on the tensor cores. What bounds it, at
// LFT's tiled call (B = 400 views of 32 x 32 tokens, D = 128, 8 heads of 16,
// 5 x 5): reading q, k, v once and writing o is 419 MB, 0.125 ms at 3.35
// TB/s; the products are 5.2 GFLOP (5 us on the bf16 tensor cores), the
// softmax 82 M exps. So bytes. Design:
//  - A CTA owns one image, 64 channels (64 / hd heads: four of 16, a
//    128-byte line of every token; the wrapper takes only head counts that
//    divide into such groups) and a tile of 4 x 16 query positions (small tiles, three CTAs an SM:
//    one CTA's copies fly while the others compute). It stages the
//    tile's k and v with their halo ((k_r - 1) rows, the columns its 4-wide
//    query blocks read) in shared memory by cp.async, 16 bytes a copy, zeros
//    outside the image; a staged pixel's pitch is 72 bf16, so the 8 rows of
//    an ldmatrix (8 neighbouring pixels) fall in distinct banks.
//  - A warp takes (head, 4 x 4 query block) items: the block's 16 queries
//    are the m16 rows of mma.sync m16n8k8; their keys are the (k_r + 3)
//    halo rows of 8 consecutive pixels (16 at k_c 6-7) over the block, one
//    n-tile a halo row. q's A fragments come straight from global memory,
//    the warp's first item's with the CTA's copies, each next one's
//    through the item before it.
//    S = q k^T (K fragments by ldmatrix), scaled, masked (slots outside a
//    query's window or the image -inf) and kept in registers; one max and
//    sum per row by quad shuffles, exp2 on the SFU; P, rounded to bf16 in
//    registers, is the A fragment of P V (V fragments by ldmatrix.trans).
//    Halo rows outside the image are skipped. The output leaves from the
//    accumulators, 4 bytes a store.
// The one new rounding against the float32 twin is P to bf16 (relative
// 2^-9) before P V.
//
// float32: local_mha_kernel, on the CUDA cores, for the float32 checks and
// gradients: one thread a (token, head), q_h in registers, its window's keys
// and values read through L1 and an online softmax over them.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 4, kTW = 16;    // a CTA's query tile (rows, columns)
constexpr int kBlk = 4;             // a warp item's 4 x 4 query block
constexpr int kMaxWindow = 7;
constexpr int kGroupCols = 64;      // channels a CTA stages: 64 / hd heads
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int h, w, D, k_r, k_c, ry, rx;
  int tiles_x, tiles, groups;
  float sc;  // 1 / sqrt(hd) * log2(e): scores in log2 units, exp2 below
};

// d += a . b on m16n8k8 (bf16 operands, float32 sums): a0 (row g, k 2t..2t+1),
// a1 (row g + 8, same k); b0 (k 2t..2t+1, column g)
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One 8x8 bf16 matrix from shared memory: lane l (< 8) gives row l's address
// (16 bytes). Thread (g, t) gets row g, columns 2t, 2t + 1; with kTrans
// rows 2t, 2t + 1 of column g.
template <bool kTrans>
__device__ __forceinline__ uint32_t ldsm_x1(const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint32_t r;
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n" : "=r"(r) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r) : "r"(a));
  return r;
}

// A kernel instance takes windows of up to W x W (W 5 or 7): n-tiles (8 keys
// each) a halo row of a block, 1 up to 5 columns, 2 up to 7; halo rows of a
// block; staged columns of a CTA
__host__ __device__ constexpr int row_tiles(int W) { return W <= 5 ? 1 : 2; }
__host__ __device__ constexpr int halo_rows(int W) { return W + kBlk - 1; }
__host__ __device__ constexpr int staged_cols(int W) { return kTW - kBlk + 8 * row_tiles(W); }

// An item's query block's A fragments (m16n8k8, one pair a k-step of 8
// channels): thread (g, t) holds query rows g (at (qy0 + g/4, qx0 + g%4))
// and g + 8 (two rows down), channels 2t, 2t + 1 of each step; zeros for
// queries outside the image
template <int HD, int BX, int BY>
__device__ __forceinline__ void load_q(const Params& p, size_t img, int y0, int x0, int c0,
                                       int item, int lane, uint32_t (&qa)[HD / 8][2]) {
  const int hh = item / (BY * BX), blk = item - hh * (BY * BX);
  const int qy0 = y0 + blk / BX * kBlk, qx = x0 + blk % BX * kBlk + lane / 4 % 4;
  const bf16* src = p.q + c0 + hh * HD + 2 * (lane % 4);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int qy = qy0 + lane / 16 + 2 * f;
    const bool in = qy < p.h && qx < p.w;
    const bf16* row = src + (img + (size_t)qy * p.w + qx) * p.D;
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) qa[ks][f] = in ? lfsr::ld32(row + ks * 8) : 0u;
  }
}

// q, k, v, o [B, h*w, D] bfloat16; kGroupCols channels (HC heads of HD) a
// CTA; windows of up to W x W
template <int HD, int W>
__global__ void __launch_bounds__(kThreads, 3) local_mha_mma_kernel(Params p) {
  constexpr int NTR = row_tiles(W), MR = halo_rows(W);
  constexpr int HC = kGroupCols / HD, CW = kGroupCols;  // heads, staged channels
  constexpr int CP = CW + 8;    // a staged pixel's pitch (bf16)
  constexpr int SW = staged_cols(W);
  constexpr int KS = HD / 8;    // k-steps of q k^T; n-tiles of the output
  constexpr int BX = kTW / kBlk, BY = kTH / kBlk;
  constexpr int kItems = HC * BY * BX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SH = kTH + p.k_r - 1;
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [SH][SW][CP]
  bf16* s_v = s_k + (size_t)SH * SW * CP;

  int cta = blockIdx.x;
  const int tile = cta % p.tiles;
  cta /= p.tiles;
  const int c0 = (cta % p.groups) * CW;
  const size_t img = (size_t)(cta / p.groups) * p.h * p.w;  // the image's first token
  const int y0 = tile / p.tiles_x * kTH, x0 = tile % p.tiles_x * kTW;

  // the tile's keys and values with their halo, zeros outside the image
  constexpr int G = CW / 8;  // 16-byte granules a staged pixel
  const int top = y0 - p.ry, left = x0 - p.rx;
  for (int i = threadIdx.x; i < SH * SW * G; i += kThreads) {
    const int px = i / G, gi = i - px * G;
    const int sy = px / SW, sx = px - sy * SW;
    const int gy = top + sy, gx = left + sx;
    const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w;
    const size_t off = in ? (img + (size_t)gy * p.w + gx) * p.D + c0 + gi * 8 : 0;
    lfsr::cp_async16_zfill(s_k + (size_t)px * CP + gi * 8, p.k + off, in);
    lfsr::cp_async16_zfill(s_v + (size_t)px * CP + gi * 8, p.v + off, in);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's first item's queries fly with the copies; each next one's
  // through the item before it
  uint32_t qa[KS][2], qn[KS][2];
  if (warp < kItems) load_q<HD, BX, BY>(p, img, y0, x0, c0, warp, lane, qa);
  lfsr::cp_async_wait_all();
  __syncthreads();

  const int KR = p.k_r + kBlk - 1;  // halo rows of a block
  for (int item = warp; item < kItems; item += kWarps) {
    if (item + kWarps < kItems) load_q<HD, BX, BY>(p, img, y0, x0, c0, item + kWarps, lane, qn);
    const int hh = item / (BY * BX), blk = item - hh * (BY * BX);
    const int by = blk / BX, bx = blk - by * BX;
    const int qy0 = y0 + by * kBlk, qx0 = x0 + bx * kBlk;
    if (qy0 < p.h && qx0 < p.w) {  // else the block lies outside the image
      // this thread's query rows of the mma: g at (qy0 + g/4, qx), g + 8 two rows down
      const int qr = g / 4, qx = qx0 + g % 4;
      const int col = c0 + hh * HD;
      // the staged pixel of this lane's key (lane % 8) in the block's first halo row
      const int pix0 = by * kBlk * SW + bx * kBlk + (lane & 7);
      // this thread's key columns (n = nt * 8 + 2t + c): inside its queries'
      // window (both rows share the column) and inside the image
      bool colok[NTR][2];
#pragma unroll
      for (int nt = 0; nt < NTR; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = nt * 8 + 2 * t + c, gx = qx0 - p.rx + n;
          colok[nt][c] = (unsigned)(n - g % 4) < (unsigned)p.k_c && gx >= 0 && gx < p.w;
        }

      // S = q k^T over the block's halo rows, masked, in log2 units
      float s[MR][NTR][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jr = 0; jr < MR; ++jr) {
        const int gy = qy0 - p.ry + jr;
        const bool live = jr < KR && gy >= 0 && gy < p.h;  // the same for the whole warp
        bool rowok[2];
#pragma unroll
        for (int f = 0; f < 2; ++f)
          rowok[f] = live && (unsigned)(jr - qr - 2 * f) < (unsigned)p.k_r;
#pragma unroll
        for (int nt = 0; nt < NTR; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          if (live) {
            const bf16* kp = s_k + (size_t)(pix0 + jr * SW + nt * 8) * CP + hh * HD;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              mma_k8(d, qa[ks][0], qa[ks][1], ldsm_x1<false>(kp + ks * 8));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = rowok[e >> 1] && colok[nt][e & 1] ? d[e] * p.sc : -INFINITY;
            s[jr][nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
      // softmax: a row's scores lie on one quad
      float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        mx[f] = fmaxf(mx[f], __shfl_xor_sync(0xffffffffu, mx[f], 1));
        mx[f] = fmaxf(mx[f], __shfl_xor_sync(0xffffffffu, mx[f], 2));
        base[f] = mx[f] == -INFINITY ? 0.f : mx[f];  // a row with no key (outside the image)
      }
#pragma unroll
      for (int jr = 0; jr < MR; ++jr)
#pragma unroll
        for (int nt = 0; nt < NTR; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[jr][nt][e] = lfsr::ex2(s[jr][nt][e] - base[e >> 1]);
            sum[e >> 1] += s[jr][nt][e];
          }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        sum[f] += __shfl_xor_sync(0xffffffffu, sum[f], 1);
        sum[f] += __shfl_xor_sync(0xffffffffu, sum[f], 2);
      }
      // o = P V: a halo row's P (16 queries x 8 keys) is the A fragment of one k-step
      float acc[KS][4] = {};
#pragma unroll
      for (int jr = 0; jr < MR; ++jr) {
        const int gy = qy0 - p.ry + jr;
        if (!(jr < KR && gy >= 0 && gy < p.h)) continue;
#pragma unroll
        for (int nt = 0; nt < NTR; ++nt) {
          const uint32_t a0 = lfsr::pack_bf16(s[jr][nt][0], s[jr][nt][1]);
          const uint32_t a1 = lfsr::pack_bf16(s[jr][nt][2], s[jr][nt][3]);
          const bf16* vp = s_v + (size_t)(pix0 + jr * SW + nt * 8) * CP + hh * HD;
#pragma unroll
          for (int no = 0; no < KS; ++no) mma_k8(acc[no], a0, a1, ldsm_x1<true>(vp + no * 8));
        }
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int qy = qy0 + qr + 2 * f;
        if (qy >= p.h || qx >= p.w) continue;
        const float inv = 1.f / sum[f];
        bf16* dst = p.o + (img + (size_t)qy * p.w + qx) * p.D + col + 2 * t;
#pragma unroll
        for (int no = 0; no < KS; ++no)
          *reinterpret_cast<uint32_t*>(dst + no * 8) =
              lfsr::pack_bf16(acc[no][2 * f] * inv, acc[no][2 * f + 1] * inv);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) qa[ks][0] = qn[ks][0], qa[ks][1] = qn[ks][1];
  }
}

template <int W>
size_t mma_smem_bytes(int k_r) {
  return 2 * sizeof(bf16) * (size_t)(kTH + k_r - 1) * staged_cols(W) * (kGroupCols + 8);
}

// kGroupCols / HD heads a CTA (the wrapper takes only head counts they divide)
template <int HD, int W>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int h, int w,
                       int D, int heads, int k_r, int k_c, float qscale, cudaStream_t s) {
  const size_t smem = mma_smem_bytes<W>(k_r);
  cudaError_t e = lfsr::set_smem((const void*)local_mha_mma_kernel<HD, W>, smem);
  if (e != cudaSuccess) return e;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.h = h, p.w = w, p.D = D, p.k_r = k_r, p.k_c = k_c, p.ry = k_r / 2, p.rx = k_c / 2;
  p.tiles_x = (w + kTW - 1) / kTW;
  p.tiles = p.tiles_x * ((h + kTH - 1) / kTH);
  p.groups = heads / (kGroupCols / HD);
  p.sc = qscale * kLog2e;
  const long ctas = (long)B * p.groups * p.tiles;
  if (ctas > 0x7fffffffL) return cudaErrorInvalidValue;
  local_mha_mma_kernel<HD, W><<<(unsigned)ctas, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t by_head_dim(const void* q, const void* k, const void* v, void* o, int B, int h,
                        int w, int D, int heads, int k_r, int k_c, float qscale, cudaStream_t s) {
  switch (D / heads) {
    case 8: return launch_mma<8, W>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
    case 16: return launch_mma<16, W>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
    case 32: return launch_mma<32, W>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------------------
// float32: CUDA cores
// --------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
local_mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, long tasks, int h, int w,
                 int D, int heads, int k_r, int k_c, float qscale) {
  const int ry = k_r / 2, rx = k_c / 2;
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < tasks;
       i += (long)gridDim.x * kThreads) {
    // task (image, token, head), heads fastest: a warp reads whole rows of q
    const int hh = (int)(i % heads);
    const long tok = i / heads;
    const int x = (int)(tok % w), y = (int)(tok / w % h);
    const size_t first = (size_t)(tok / ((long)h * w)) * h * w;  // the image's first token
    const size_t row = (size_t)tok * D + hh * HD;
    float qr[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = q[row + d] * qscale;
      acc[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;  // the token's own slot is always in: l ends >= 1
    for (int yy = max(y - ry, 0); yy < min(y - ry + k_r, h); ++yy)
      for (int xx = max(x - rx, 0); xx < min(x - rx + k_c, w); ++xx) {
        const size_t kv = (first + (size_t)yy * w + xx) * D + hh * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], __ldg(k + kv + d), dot);
        const float mn = fmaxf(m, dot);
        const float corr = expf(m - mn), e = expf(dot - mn);  // corr 0 at the first slot
        l = fmaf(l, corr, e);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(acc[d], corr, e * __ldg(v + kv + d));
        m = mn;
      }
#pragma unroll
    for (int d = 0; d < HD; ++d) o[row + d] = acc[d] / l;
  }
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int B, int h, int w,
                       int D, int heads, int k_r, int k_c, float qscale, cudaStream_t s) {
  const long tasks = (long)B * h * w * heads;
  const long need = (tasks + kThreads - 1) / kThreads, blocks = need < (1L << 20) ? need : 1L << 20;
  local_mha_kernel<HD><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), tasks, h, w, D, heads, k_r, k_c, qscale);
  return cudaGetLastError();
}

bool valid(int B, int h, int w, int D, int heads, int k_r, int k_c) {
  if (B < 0 || h < 1 || w < 1 || heads < 1 || D % heads) return false;
  if (k_r < 1 || k_c < 1 || k_r > kMaxWindow || k_c > kMaxWindow) return false;
  const int hd = D / heads;  // a CTA's 64 channels hold whole heads: heads a multiple of 64 / hd
  return (hd == 8 || hd == 16 || hd == 32) && heads % (kGroupCols / hd) == 0;
}

}  // namespace

// The tensor-core kernel: q, k, v, o bfloat16 [B, h*w, D], contiguous and
// 16-byte aligned, hd = D / heads in {8, 16, 32}, heads a multiple of 64 / hd,
// 1 <= k_r, k_c <= 7
LFSR_EXPORT int lfsr_local_mha_mma(const void* q, const void* k, const void* v, void* o, int B,
                                   int h, int w, int D, int heads, int k_r, int k_c, float qscale,
                                   void* stream) {
  if (!valid(B, h, w, D, heads, k_r, k_c)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_r <= 5 && k_c <= 5)
    return by_head_dim<5>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
  return by_head_dim<7>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
}

// The CUDA-core kernel: q, k, v, o float32 [B, h*w, D], contiguous
LFSR_EXPORT int lfsr_local_mha(const void* q, const void* k, const void* v, void* o, int B, int h,
                               int w, int D, int heads, int k_r, int k_c, float qscale,
                               void* stream) {
  if (!valid(B, h, w, D, heads, k_r, k_c)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / heads) {
    case 8: return launch_fma<8>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
    case 16: return launch_fma<16>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
    default: return launch_fma<32>(q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, s);
  }
}
