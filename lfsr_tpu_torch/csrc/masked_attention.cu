// K8 — banded-mask multi-head attention over short sequences (EPIT).
//
// Replaces lfsr_tpu/ops/pallas_masked_attention.py::_masked_mha_raw
// (masked_mha_fused): for sequences q, k, v [B, L, D] with channel-
// contiguous heads of hd = D / heads channels and one additive mask [L, L]
// shared by every sequence and head,
//   o_h = softmax(q_h k_h^T / sqrt(hd) + mask) v_h       per sequence and head,
// stored in the I/O dtype (float32 or bfloat16). Two kernels, chosen by the
// wrapper from the dtype and hd (ops/masked_attention.py::kernel_path):
//
// bfloat16 with hd in {16, 32, 64}: masked_mha_mma_kernel, on the tensor
// cores. What bounds it, at EPIT's tiled-eval call (B = 320 sequences of
// L = 160 tokens, D = 128, 8 heads): reading q, k, v once and writing o is
// 52.5 MB, 15.7 us at 3.35 TB/s; the products q k^T and p v are 4.19 GFLOP,
// 4.2 us on the bf16 tensor cores. So bytes. Design (FlashAttention-2 on
// mma.sync m16n8k16):
//  - A CTA owns one sequence and kHeadCols / hd heads (64 channels: 128 B of
//    every row, so the staging loads are whole 16-byte chunks, by cp.async;
//    fewer heads where they do not divide ``heads``). It stages their q, k,
//    v rows in shared memory, rows padded to a multiple of 16 with zeros, at
//    a pitch of 72 bf16 so ldmatrix is conflict-free. Its warps take (head,
//    16 query rows) items.
//  - A warp reads its Q fragments once (ldmatrix), then walks the keys in
//    blocks of kKeyBlock: S = Q K^T (K fragments by ldmatrix), scaled, plus
//    the mask read straight from the row-major [L, L] mask (rows g and g + 8
//    of the accumulator layout, two adjacent keys per thread; a block's
//    loads are issued before its products), keys past L -inf.
//  - The row max and sum by quad shuffles, exp2 in float32 (the SFU's ex2
//    alone), an online softmax carried over the blocks; n-tiles past the
//    padded length are skipped.
//  - P, rounded to bf16 in registers, is the A fragment of P V (V fragments
//    by ldmatrix.trans). The output goes back over the warp's own q rows in
//    shared memory and leaves the CTA in 16-byte stores.
// The one new rounding against the float32 twin is P to bf16 (relative
// 2^-9) before P V.
//
// float32, or hd = 8: masked_mha_kernel, on the CUDA cores (the float32
// gradient checks compare in float32; as K10 splits). What bounds it: the
// same bytes, but its products are float32 FMAs (63 us at the tiled call).
// One block per (sequence, head). K_h and V_h ([L][hd] float32) are staged
// in shared memory and read back as float4 (every thread of a warp reads the
// same key row, so shared memory broadcasts it). Each thread owns query
// rows: it keeps q_i (pre-scaled by 1/sqrt(hd)) and its output row in
// registers and walks the keys in chunks of 8 with the same online softmax.
// It takes the mask TRANSPOSED ([key][query], made by the wrapper), so a
// warp's 32 query rows read 32 adjacent floats of one key's column.
//
// The TPU kernel's head-masked stacked K/V ([L, heads*L, D], 8x the FLOPs)
// only keeps the TPU's matrix unit fed and is not carried over. In both
// kernels a row whose mask is -inf everywhere gives 0/0 (NaN), as the twin's
// softmax does; EPIT's band masks never produce one, since every token's
// own position (the diagonal) lies inside its band.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;  // keys per softmax chunk (their scores stay in registers)

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
masked_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ mask_t, T* __restrict__ o, int L, int D, int heads,
                  float qscale) {
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);  // [L][HD]
  float* s_v = s_k + L * HD;                      // [L][HD]
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t base = (size_t)b * L * D + (size_t)h * HD;

  for (int idx = threadIdx.x; idx < L * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    const size_t off = base + (size_t)j * D + d;
    s_k[idx] = lfsr::load(k + off);
    s_v[idx] = lfsr::load(v + off);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const size_t row = base + (size_t)i * D;
    float qr[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = lfsr::load(q + row + d) * qscale;
      acc[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < L; j0 += kChunk) {
      float s[kChunk];
      float mc = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        s[jj] = -INFINITY;
        if (j < L) {
          const float4* kr = reinterpret_cast<const float4*>(s_k + j * HD);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kv = kr[d4];
            dot = fmaf(qr[4 * d4], kv.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
          }
          s[jj] = dot + __ldg(mask_t + (size_t)j * L + i);
        }
        mc = fmaxf(mc, s[jj]);
      }
      // while every key so far is masked out (mc = -inf), subtract 0:
      // exp(-inf) = 0 and the sums stay 0
      const float base_m = mc == -INFINITY ? 0.f : mc;
      const float corr = expf(m - base_m);  // 0 while m is still -inf
      m = mc;
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < L) {
          const float e = expf(s[jj] - base_m);
          const float4* vr = reinterpret_cast<const float4*>(s_v + j * HD);
          l += e;
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4] = fmaf(e, vv.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(e, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(e, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(e, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) lfsr::store(o + row + d, acc[d] / l);
  }
}


// --------------------------------------------------------------------------
// bfloat16: tensor cores
// --------------------------------------------------------------------------

constexpr int kHeadCols = 64;        // channels (heads x hd) a CTA stages
constexpr int kPitch = kHeadCols + 8;  // bf16 per staged row: conflict-free ldmatrix
constexpr int kMmaWarps = 8;
// keys per online-softmax block (4 n-tiles): 32 ran faster than 16, 48, 64
// and 160 at EPIT's shapes on the H100 (PERF.md, K8)
constexpr int kKeyBlock = 32;
constexpr float kLog2e = 1.4426950408889634f;

// q, k, v, o [B, L, D] bfloat16 (16-byte aligned rows: D % 8 == 0), mask
// [L, L] float32 row-major; HC heads of HD channels per CTA
template <int HD, int HC>
__global__ void __launch_bounds__(32 * kMmaWarps)
masked_mha_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ o, int L, int D, int heads, float qscale) {
  constexpr int CW = HD * HC;         // staged channels
  constexpr int KS = HD / 16;         // k-steps of q k^T
  constexpr int NO = HD / 8;          // n-tiles of the output
  constexpr int NB = kKeyBlock / 8;   // n-tiles of a key block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) / 16 * 16;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Lp][kPitch]
  __nv_bfloat16* s_k = s_q + (size_t)Lp * kPitch;
  __nv_bfloat16* s_v = s_k + (size_t)Lp * kPitch;

  const int groups = heads / HC;
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * CW;  // first staged channel
  const size_t base = (size_t)b * L * D + c0;

  // stage q, k, v: 16-byte chunks, rows past L zero
  constexpr int kChunks = CW / 8;
  for (int i = threadIdx.x; i < Lp * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const size_t off = base + (size_t)r * D + c;
    __nv_bfloat16* dq = s_q + r * kPitch + c;
    __nv_bfloat16* dk = s_k + r * kPitch + c;
    __nv_bfloat16* dv = s_v + r * kPitch + c;
    if (r < L) {
      lfsr::cp_async16(dq, q + off);
      lfsr::cp_async16(dk, k + off);
      lfsr::cp_async16(dv, v + off);
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dq) = z;
      *reinterpret_cast<uint4*>(dk) = z;
      *reinterpret_cast<uint4*>(dv) = z;
    }
  }
  lfsr::cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = Lp / 16;
  const float sc = qscale * kLog2e;  // scores in log2 units: exp2 below
  for (int item = warp; item < HC * mtiles; item += kMmaWarps) {
    const int hh = item / mtiles, m0 = (item % mtiles) * 16;
    const int col = hh * HD;  // the head's first staged channel
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      lfsr::ldmatrix_x4(qa[ks], s_q + (m0 + lane % 16) * kPitch + col + ks * 16 + (lane / 16) * 8);
    const int r0 = m0 + g, r1 = m0 + g + 8;  // this thread's two query rows
    const float* mrow0 = mask + (size_t)min(r0, L - 1) * L;
    const float* mrow1 = mask + (size_t)min(r1, L - 1) * L;
    float acc[NO][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kb = 0; kb < Lp; kb += kKeyBlock) {
      // the block's mask entries first, all loads issued before any is used
      // (keys past L read key L - 1 and are set to -inf below)
      // n-tiles of this block inside the padded keys: the rest are skipped
      const int nvalid = min(NB, (Lp - kb) / 8);
      float mv[NB][4];
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
        if (nt < nvalid) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mv[nt][c] = __ldg((c < 2 ? mrow0 : mrow1) + min(kb + nt * 8 + 2 * t + (c & 1), L - 1));
        }
      float s[NB][4];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {  // n-tile pairs: 16 keys
        const int n0 = kb + np * 16;
#pragma unroll
        for (int c = 0; c < 4; ++c) s[2 * np][c] = s[2 * np + 1][c] = 0.f;
        if (2 * np < nvalid) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t kf[4];  // b0, b1 of keys n0..n0+7, then of n0+8..n0+15
            lfsr::ldmatrix_x4(kf, s_k + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kPitch + col +
                                      ks * 16 + ((lane >> 3) & 1) * 8);
            lfsr::mma_bf16(s[2 * np], qa[ks], kf[0], kf[1]);
            lfsr::mma_bf16(s[2 * np + 1], qa[ks], kf[2], kf[3]);
          }
        }
      }
      // scale, mask (keys past L: -inf), block max per row
      float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        if (nt >= nvalid) break;
        const int j = kb + nt * 8 + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = j + (c & 1) < L ? fmaf(s[nt][c], sc, mv[nt][c] * kLog2e) : -INFINITY;
          s[nt][c] = x;
          bm[c >> 1] = fmaxf(bm[c >> 1], x);
        }
      }
      float corr[2], base_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
        bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
        const float mn = fmaxf(m[h], bm[h]);
        // while every key so far is masked out (mn = -inf), subtract 0:
        // exp(-inf) = 0 and the sums stay 0
        base_m[h] = mn == -INFINITY ? 0.f : mn;
        corr[h] = lfsr::ex2(m[h] - base_m[h]);  // 0 while m is still -inf
        m[h] = mn;
      }
      float bsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        if (nt >= nvalid) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = lfsr::ex2(s[nt][c] - base_m[c >> 1]);
          bsum[c >> 1] += s[nt][c];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 1);
        bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 2);
        l[h] = fmaf(l[h], corr[h], bsum[h]);
      }
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        acc[no][0] *= corr[0]; acc[no][1] *= corr[0];
        acc[no][2] *= corr[1]; acc[no][3] *= corr[1];
      }
      // o += P V: P's accumulators of n-tiles 2kp, 2kp + 1 are the A fragment
      // over keys kb + 16 kp .. + 15
#pragma unroll
      for (int kp = 0; kp < NB / 2; ++kp) {
        const int k0 = kb + kp * 16;
        if (2 * kp >= nvalid) break;
        const uint32_t pa[4] = {lfsr::pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                                lfsr::pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                                lfsr::pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                                lfsr::pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vf[4];  // b0, b1 of channels 16 np..+7, then of +8..+15
          lfsr::ldmatrix_x4<true>(vf, s_v + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                                          col + np * 16 + (lane >> 4) * 8);
          lfsr::mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          lfsr::mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    // o over this warp's own q rows (no other warp reads them)
#pragma unroll
    for (int no = 0; no < NO; ++no) {
      const int c = col + no * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(s_q + r0 * kPitch + c) =
          lfsr::pack_bf16(acc[no][0] / l[0], acc[no][1] / l[0]);
      *reinterpret_cast<uint32_t*>(s_q + r1 * kPitch + c) =
          lfsr::pack_bf16(acc[no][2] / l[1], acc[no][3] / l[1]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(o + base + (size_t)r * D + c) =
        *reinterpret_cast<const uint4*>(s_q + r * kPitch + c);
  }
}

size_t mma_smem_bytes(int L) {
  return 3 * sizeof(__nv_bfloat16) * (size_t)((L + 15) / 16 * 16) * kPitch;
}

template <int HD, int HC>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask, void* o,
                       int B, int L, int D, int heads, float qscale, cudaStream_t s) {
  const size_t smem = mma_smem_bytes(L);
  cudaError_t e = lfsr::set_smem((const void*)masked_mha_mma_kernel<HD, HC>, smem);
  if (e != cudaSuccess) return e;
  masked_mha_mma_kernel<HD, HC><<<(unsigned)((long)B * (heads / HC)), 32 * kMmaWarps, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(o), L, D, heads, qscale);
  return cudaGetLastError();
}

// heads per CTA: kHeadCols / hd, halved until it divides heads
template <int HD>
cudaError_t by_heads_per_cta(const void* q, const void* k, const void* v, const void* mask,
                             void* o, int B, int L, int D, int heads, float qscale,
                             cudaStream_t s) {
  int hc = kHeadCols / HD;
  while (heads % hc) hc /= 2;
  if constexpr (HD <= 16)
    if (hc == 4) return launch_mma<HD, 4>(q, k, v, mask, o, B, L, D, heads, qscale, s);
  if constexpr (HD <= 32)
    if (hc == 2) return launch_mma<HD, 2>(q, k, v, mask, o, B, L, D, heads, qscale, s);
  return launch_mma<HD, 1>(q, k, v, mask, o, B, L, D, heads, qscale, s);
}

size_t smem_bytes(int L, int hd) { return sizeof(float) * 2 * (size_t)L * hd; }

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask_t, void* o, int B,
                   int L, int D, int heads, float qscale, cudaStream_t s) {
  const size_t smem = smem_bytes(L, HD);
  cudaError_t e = cudaFuncSetAttribute(masked_mha_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = L < kMaxThreads ? (L + 31) / 32 * 32 : kMaxThreads;
  masked_mha_kernel<T, HD><<<(unsigned)((long)B * heads), threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask_t), static_cast<T*>(o), L, D, heads, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(const void* q, const void* k, const void* v, const void* mask_t,
                        void* o, int B, int L, int D, int heads, float qscale, cudaStream_t s) {
  switch (D / heads) {
    case 8: return launch<T, 8>(q, k, v, mask_t, o, B, L, D, heads, qscale, s);
    case 16: return launch<T, 16>(q, k, v, mask_t, o, B, L, D, heads, qscale, s);
    case 32: return launch<T, 32>(q, k, v, mask_t, o, B, L, D, heads, qscale, s);
    case 64: return launch<T, 64>(q, k, v, mask_t, o, B, L, D, heads, qscale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mask_t: the additive mask transposed, [L keys][L queries] float32
LFSR_EXPORT int lfsr_masked_mha(const void* q, const void* k, const void* v, const void* mask_t,
                                void* o, int B, int L, int D, int heads, float qscale, int dtype,
                                void* stream) {
  if (B < 0 || L < 1 || heads < 1 || D % heads) return cudaErrorInvalidValue;
  if (smem_bytes(L, D / heads) > 227 * 1024) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32) return by_head_dim<float>(q, k, v, mask_t, o, B, L, D, heads, qscale, s);
  if (dtype == lfsr::kBF16)
    return by_head_dim<__nv_bfloat16>(q, k, v, mask_t, o, B, L, D, heads, qscale, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel: q, k, v, o bfloat16 with hd = D / heads in {16, 32,
// 64}, contiguous and 16-byte aligned; mask [L queries][L keys] float32, row-major as given
LFSR_EXPORT int lfsr_masked_mha_mma(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, int B, int L, int D, int heads,
                                    float qscale, void* stream) {
  if (B < 0 || L < 1 || heads < 1 || D % heads || D % 8) return cudaErrorInvalidValue;
  if (mma_smem_bytes(L) > 227 * 1024) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / heads) {
    case 16: return by_heads_per_cta<16>(q, k, v, mask, o, B, L, D, heads, qscale, s);
    case 32: return by_heads_per_cta<32>(q, k, v, mask, o, B, L, D, heads, qscale, s);
    case 64: return by_heads_per_cta<64>(q, k, v, mask, o, B, L, D, heads, qscale, s);
    default: return cudaErrorInvalidValue;
  }
}
