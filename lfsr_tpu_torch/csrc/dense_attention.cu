// K15 — multi-head attention with no mask, queries and keys of their own
// lengths (LF-DET's spatial-reduction and MacPI-window attentions).
//
// No TPU kernel matches it: JAX runs flax's dot_product_attention as XLA
// ops. For q [B, Lq, D] and k, v [B, Lk, D] (channel-contiguous heads of hd
// = D / heads channels; k and v rows evenly spaced, so both may be the two
// halves of one [B, Lk, 2D] projection),
//   o_h = softmax(q_h k_h^T / sqrt(hd)) v_h        per sequence and head,
// stored in the I/O dtype, o [B, Lq, D] contiguous. Two kernels, chosen by
// the wrapper (ops/dense_attention.py::kernel_path):
//
// bfloat16 with hd = 16: dense_mha_mma_kernel, on the tensor cores. What
// bounds it, at LF-DET's four sites of a 16-tile call (q, k, v, o read and
// written once; products 4 B Lq Lk D at 989 TFLOP/s; one exp a score):
// spatial (B 400, Lq 1024, Lk 256) 131 MB, 39 us by bytes, but 419 M
// exponentials, ~100 us on the SFUs' 16 a clock an SM; the windows (25, 100
// and 225 tokens) 210-223 MB, 63-67 us by bytes. At hd 16 a score costs one
// exp and ~4 other instructions against 1/16 of an m16n8k16 product, so the
// softmax, not the tensor cores or the bytes, sets the pace, and its
// dependent chain (products, max, shuffles, exp, sum) the latency. Design
// (FlashAttention-2 on mma.sync m16n8k16, as K8's tensor-core kernel,
// without the mask):
//  - A CTA owns CW channels (CW / 16 whole heads: 64, or 32 or 16 where a
//    long Lk would not fit) of S whole sequences (short ones, packed so a CTA
//    has work for its 8 warps) or of one block of QB query rows of one
//    sequence (long ones). It stages the sequences' k and v rows (Lk rounded
//    up to 16, zero rows past it) and its q rows by cp.async, at a pitch of
//    CW + 8 bf16 so ldmatrix is conflict-free. The host's plan
//    (ops/dense_attention.py::mma_plan) picks CW, S and QB; two CTAs fit an
//    SM at every site of the cell (at most 128 registers a thread).
//  - Its warps take (sequence, head, 32 query rows) items: two m-tiles whose
//    S = Q K^T and P V share each K and V fragment (ldmatrix), which halves
//    the shared-memory reads a score and gives the warp two independent
//    softmax chains. A warp walks the keys in blocks of kKeyBlock (64: 8%
//    to 10% faster than 32 at the spatial and 15-wide sites, equal at 5),
//    keys past Lk -inf; the row max and sum by quad shuffles; exp2 on the
//    SFU with the 1/sqrt(hd) log2(e) scale folded into its argument; an
//    online softmax over the blocks (a two-pass form, the maxima first and
//    no rescaling, ran 10-13% slower); P rounded to bf16 in registers is the
//    A fragment of P V (V by ldmatrix.trans). The output goes over the
//    warp's own q rows in shared memory and leaves the CTA in 16-byte
//    stores.
// The one rounding the float32 twin does not make is P to bf16 (relative
// 2^-9) before P V; flax's bf16 attention rounds the scores and P itself.
//
// float32 (the gradient checks), hd 16: dense_mha_kernel on the CUDA cores,
// one CTA per (sequence, head); K_h and V_h staged in shared memory as
// float32, a thread a query row at a time with the same online softmax in
// chunks of 8 keys.
#include "common.cuh"

namespace {

constexpr int kHD = 16;  // the one head dim LF-DET has, on both kernels
constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;  // keys per softmax chunk of the CUDA-core kernel

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dense_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Lq, int Lk, int D, int kstride, int heads,
                 float qscale) {
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);  // [Lk][kHD]
  float* s_v = s_k + Lk * kHD;                    // [Lk][kHD]
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t kbase = (size_t)b * Lk * kstride + (size_t)h * kHD;
  const size_t qbase = (size_t)b * Lq * D + (size_t)h * kHD;

  for (int idx = threadIdx.x; idx < Lk * kHD; idx += blockDim.x) {
    const int j = idx / kHD, d = idx % kHD;
    const size_t off = kbase + (size_t)j * kstride + d;
    s_k[idx] = lfsr::load(k + off);
    s_v[idx] = lfsr::load(v + off);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Lq; i += blockDim.x) {
    const size_t row = qbase + (size_t)i * D;
    float qr[kHD], acc[kHD];
#pragma unroll
    for (int d = 0; d < kHD; ++d) {
      qr[d] = lfsr::load(q + row + d) * qscale;
      acc[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < Lk; j0 += kChunk) {
      float s[kChunk];
      float mc = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        s[jj] = -INFINITY;
        if (j < Lk) {
          const float4* kr = reinterpret_cast<const float4*>(s_k + j * kHD);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < kHD / 4; ++d4) {
            const float4 kv = kr[d4];
            dot = fmaf(qr[4 * d4], kv.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
          }
          s[jj] = dot;
        }
        mc = fmaxf(mc, s[jj]);
      }
      const float corr = expf(m - mc);  // 0 on the first chunk (m = -inf)
      m = mc;
      l *= corr;
#pragma unroll
      for (int d = 0; d < kHD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < Lk) {
          const float e = expf(s[jj] - mc);
          const float4* vr = reinterpret_cast<const float4*>(s_v + j * kHD);
          l += e;
#pragma unroll
          for (int d4 = 0; d4 < kHD / 4; ++d4) {
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
    for (int d = 0; d < kHD; ++d) lfsr::store(o + row + d, acc[d] / l);
  }
}

size_t fma_smem_bytes(int Lk) { return sizeof(float) * 2 * (size_t)Lk * kHD; }

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                       int Lk, int D, int kstride, int heads, float qscale, cudaStream_t s) {
  const size_t smem = fma_smem_bytes(Lk);
  cudaError_t e = cudaFuncSetAttribute(dense_mha_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = Lq < kMaxThreads ? (Lq + 31) / 32 * 32 : kMaxThreads;
  dense_mha_kernel<T><<<(unsigned)((long)B * heads), threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Lq, Lk, D, kstride, heads, qscale);
  return cudaGetLastError();
}


// --------------------------------------------------------------------------
// bfloat16, hd 16: tensor cores
// --------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kKeyBlock = 64;  // keys per online-softmax block (8 n-tiles)
constexpr int kRows = 2;       // m-tiles of 16 query rows a warp item: they share K, V
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// q, o [B, Lq, D], k, v [B, Lk, kstride] (their D channels first) bfloat16,
// 16-byte aligned rows; CW channels (CW / 16 heads) of S sequences, QB query
// rows of each (a multiple of 16 kRows), a CTA
template <int CW>
__global__ void __launch_bounds__(32 * kMmaWarps, 2)
dense_mha_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int B,
                     int Lq, int Lk, int D, int kstride, int S, int QB, float qscale) {
  constexpr int P = CW + 8;       // staged row pitch, bf16
  constexpr int HC = CW / kHD;    // heads a CTA
  constexpr int NB = kKeyBlock / 8;
  constexpr int kChunks = CW / 8;  // 16-byte chunks of a staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lkp = up16(Lk);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [S][Lkp][P]
  __nv_bfloat16* s_v = s_k + (size_t)S * Lkp * P;                    // [S][Lkp][P]
  __nv_bfloat16* s_q = s_v + (size_t)S * Lkp * P;                    // [S][QB][P]

  // the CTA's (channel group, query block, sequence block)
  const int groups = D / CW, qblocks = (Lq + QB - 1) / QB;
  const int grp = blockIdx.x % groups;
  const int qb = (blockIdx.x / groups) % qblocks;
  const int b0 = blockIdx.x / groups / qblocks * S;
  const int nseq = min(S, B - b0);
  const int q0 = qb * QB, qrows = min(QB, Lq - q0);
  const int c0 = grp * CW;

  // stage k, v (rows past Lk zero) and q (rows past the block's zero)
  for (int i = threadIdx.x; i < nseq * Lkp * kChunks; i += blockDim.x) {
    const int sr = i / kChunks, c = (i % kChunks) * 8;
    const int sq = sr / Lkp, r = sr % Lkp;
    __nv_bfloat16* dk = s_k + (size_t)sr * P + c;
    __nv_bfloat16* dv = s_v + (size_t)sr * P + c;
    if (r < Lk) {
      const size_t off = ((size_t)(b0 + sq) * Lk + r) * kstride + c0 + c;
      lfsr::cp_async16(dk, k + off);
      lfsr::cp_async16(dv, v + off);
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dk) = z;
      *reinterpret_cast<uint4*>(dv) = z;
    }
  }
  for (int i = threadIdx.x; i < nseq * QB * kChunks; i += blockDim.x) {
    const int sr = i / kChunks, c = (i % kChunks) * 8;
    const int sq = sr / QB, r = sr % QB;
    __nv_bfloat16* dq = s_q + (size_t)sr * P + c;
    if (r < qrows)
      lfsr::cp_async16(dq, q + ((size_t)(b0 + sq) * Lq + q0 + r) * D + c0 + c);
    else
      *reinterpret_cast<uint4*>(dq) = make_uint4(0, 0, 0, 0);
  }
  lfsr::cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pairs = (qrows + 16 * kRows - 1) / (16 * kRows);
  const float sc = qscale * kLog2e;  // scores to log2 units, folded into exp2's argument
  for (int item = warp; item < nseq * HC * pairs; item += kMmaWarps) {
    const int sq = item / (HC * pairs);
    const int hh = item / pairs % HC, m0 = item % pairs * 16 * kRows;
    const int col = hh * kHD;  // the head's first staged channel
    const __nv_bfloat16* sk = s_k + (size_t)sq * Lkp * P;
    const __nv_bfloat16* sv = s_v + (size_t)sq * Lkp * P;
    __nv_bfloat16* sqr = s_q + (size_t)sq * QB * P;
    uint32_t qa[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      lfsr::ldmatrix_x4(qa[r], sqr + (m0 + 16 * r + lane % 16) * P + col + (lane / 16) * 8);
    float acc[kRows][2][4] = {};
    // running max (raw score units) and sum of rows g, g + 8 of each m-tile
    float m[kRows][2], l[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r][0] = m[r][1] = -INFINITY, l[r][0] = l[r][1] = 0.f;
    for (int kb = 0; kb < Lkp; kb += kKeyBlock) {
      // n-tiles of this block inside the padded keys: the rest are skipped
      const int nvalid = min(NB, (Lkp - kb) / 8);
      const bool full = kb + kKeyBlock <= Lk;
      float s[kRows][NB][4];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {  // n-tile pairs: 16 keys
        const int n0 = kb + np * 16;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][2 * np][c] = s[r][2 * np + 1][c] = 0.f;
        if (2 * np < nvalid) {
          uint32_t kf[4];  // b0, b1 of keys n0..n0+7, then of n0+8..n0+15
          lfsr::ldmatrix_x4(kf, sk + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + col +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            lfsr::mma_bf16(s[r][2 * np], qa[r], kf[0], kf[1]);
            lfsr::mma_bf16(s[r][2 * np + 1], qa[r], kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // keys past Lk: -inf; block max per row
        float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          if (nt >= nvalid) break;
          const int j = kb + nt * 8 + 2 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (!full && j + (c & 1) >= Lk) s[r][nt][c] = -INFINITY;
            bm[c >> 1] = fmaxf(bm[c >> 1], s[r][nt][c]);
          }
        }
        float corr[2], base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
          bm[h] = fmaxf(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
          // every block holds a key below Lk, so the running max is finite
          // from the first block on, where corr = exp2(-inf) = 0
          const float mn = fmaxf(m[r][h], bm[h]);
          corr[h] = lfsr::ex2((m[r][h] - mn) * sc);
          m[r][h] = mn;
          base[h] = -mn * sc;
        }
        float bsum[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          if (nt >= nvalid) break;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][nt][c] = lfsr::ex2(fmaf(s[r][nt][c], sc, base[c >> 1]));
            bsum[c >> 1] += s[r][nt][c];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 1);
          bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 2);
          l[r][h] = fmaf(l[r][h], corr[h], bsum[h]);
        }
#pragma unroll
        for (int no = 0; no < 2; ++no) {
          acc[r][no][0] *= corr[0]; acc[r][no][1] *= corr[0];
          acc[r][no][2] *= corr[1]; acc[r][no][3] *= corr[1];
        }
      }
      // o += P V: P's accumulators of n-tiles 2kp, 2kp + 1 are the A fragment
      // over keys kb + 16 kp .. + 15; one V fragment serves both m-tiles
#pragma unroll
      for (int kp = 0; kp < NB / 2; ++kp) {
        const int k0 = kb + kp * 16;
        if (2 * kp >= nvalid) break;
        uint32_t vf[4];  // b0, b1 of channels 0..7, then of 8..15
        lfsr::ldmatrix_x4<true>(vf, sv + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + col +
                                        (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const uint32_t pa[4] = {lfsr::pack_bf16(s[r][2 * kp][0], s[r][2 * kp][1]),
                                  lfsr::pack_bf16(s[r][2 * kp][2], s[r][2 * kp][3]),
                                  lfsr::pack_bf16(s[r][2 * kp + 1][0], s[r][2 * kp + 1][1]),
                                  lfsr::pack_bf16(s[r][2 * kp + 1][2], s[r][2 * kp + 1][3])};
          lfsr::mma_bf16(acc[r][0], pa, vf[0], vf[1]);
          lfsr::mma_bf16(acc[r][1], pa, vf[2], vf[3]);
        }
      }
    }
    // o over this item's own q rows and channels (no other item reads them)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int r0 = m0 + 16 * r + g, r1 = r0 + 8;
#pragma unroll
      for (int no = 0; no < 2; ++no) {
        const int c = col + no * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sqr + r0 * P + c) =
            lfsr::pack_bf16(acc[r][no][0] / l[r][0], acc[r][no][1] / l[r][0]);
        *reinterpret_cast<uint32_t*>(sqr + r1 * P + c) =
            lfsr::pack_bf16(acc[r][no][2] / l[r][1], acc[r][no][3] / l[r][1]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nseq * QB * kChunks; i += blockDim.x) {
    const int sr = i / kChunks, c = (i % kChunks) * 8;
    const int sq = sr / QB, r = sr % QB;
    if (r < qrows)
      *reinterpret_cast<uint4*>(o + ((size_t)(b0 + sq) * Lq + q0 + r) * D + c0 + c) =
          *reinterpret_cast<const uint4*>(s_q + (size_t)sr * P + c);
  }
}

size_t mma_smem_bytes(int Lk, int cw, int S, int QB) {
  return sizeof(__nv_bfloat16) * (size_t)(cw + 8) * S * (2 * (size_t)up16(Lk) + QB);
}

template <int CW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                       int Lk, int D, int kstride, int S, int QB, float qscale, cudaStream_t s) {
  const size_t smem = mma_smem_bytes(Lk, CW, S, QB);
  cudaError_t e = lfsr::set_smem((const void*)dense_mha_mma_kernel<CW>, smem);
  if (e != cudaSuccess) return e;
  const long ctas = (long)((B + S - 1) / S) * ((Lq + QB - 1) / QB) * (D / CW);
  dense_mha_mma_kernel<CW><<<(unsigned)ctas, 32 * kMmaWarps, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, Lq, Lk, D,
      kstride, S, QB, qscale);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core kernel: q, o [B, Lq, D] contiguous, k, v [B, Lk, kstride]
// (rows of kstride elements, their first D channels read), hd = D / heads
// 16, float32 or bfloat16 (dtype code)
LFSR_EXPORT int lfsr_dense_mha(const void* q, const void* k, const void* v, void* o, int B,
                               int Lq, int Lk, int D, int kstride, int heads, float qscale,
                               int dtype, void* stream) {
  if (B < 0 || Lq < 1 || Lk < 1 || heads < 1 || D != heads * kHD || kstride < D)
    return cudaErrorInvalidValue;
  if (fma_smem_bytes(Lk) > 227 * 1024) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kF32)
    return launch_fma<float>(q, k, v, o, B, Lq, Lk, D, kstride, heads, qscale, s);
  if (dtype == lfsr::kBF16)
    return launch_fma<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, D, kstride, heads, qscale, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel: bfloat16, hd 16, 16-byte aligned rows (D and
// kstride multiples of 8); cw in {16, 32, 64} channels of S sequences and QB
// query rows (a multiple of 32) a CTA, as ops/dense_attention.py::mma_plan
// gives them
LFSR_EXPORT int lfsr_dense_mha_mma(const void* q, const void* k, const void* v, void* o, int B,
                                   int Lq, int Lk, int D, int kstride, int cw, int S, int QB,
                                   float qscale, void* stream) {
  if (B < 0 || Lq < 1 || Lk < 1 || D % 8 || kstride % 8 || kstride < D || S < 1 || QB < 32 ||
      QB % 32 || (cw != 16 && cw != 32 && cw != 64) || D % cw)
    return cudaErrorInvalidValue;
  if (mma_smem_bytes(Lk, cw, S, QB) > 227 * 1024) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cw) {
    case 64: return launch_mma<64>(q, k, v, o, B, Lq, Lk, D, kstride, S, QB, qscale, s);
    case 32: return launch_mma<32>(q, k, v, o, B, Lq, Lk, D, kstride, S, QB, qscale, s);
    default: return launch_mma<16>(q, k, v, o, B, Lq, Lk, D, kstride, S, QB, qscale, s);
  }
}
