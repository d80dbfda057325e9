// K8 — banded-mask multi-head attention over short sequences (EPIT).
//
// Replaces lfsr_tpu/ops/pallas_masked_attention.py::_masked_mha_raw
// (masked_mha_fused): for sequences q, k, v [B, L, D] with channel-
// contiguous heads of hd = D / heads channels and one additive mask [L, L]
// shared by every sequence and head,
//   o_h = softmax(q_h k_h^T / sqrt(hd) + mask) v_h       per sequence and head,
// in float32, stored in the I/O dtype (float32 or bfloat16).
//
// What bounds it on this card, at EPIT's tiled-eval call (bf16 I/O,
// B = 320 sequences of L = 160 tokens, D = 128, 8 heads): reading q, k, v
// once and writing o is 52.5 MB, 15.7 us at 3.35 TB/s; the products
// q k^T and p v are 4.19 GFLOP, 4.2 us on the bf16 tensor cores but 63 us
// as float32 FMAs on the CUDA cores, which is what this kernel issues. At
// the batch-8 train step (B = 1280) all of it is 4x.
//
// Design: one block per (sequence, head). K_h and V_h ([L][hd] float32,
// 20 KB at L = 160, hd = 16) are staged in shared memory and read back as
// float4 (every thread of a warp reads the same key row, so shared memory
// broadcasts it). Each thread owns query rows: it keeps q_i (pre-scaled by
// 1/sqrt(hd)) and its output row in registers and walks the keys in chunks
// of 8, computing the chunk's scores plus the mask, then a max-subtracted
// softmax carried across chunks: a larger running max rescales the running
// sum and output row. The kernel takes the mask TRANSPOSED ([key][query],
// made by the wrapper), so a warp's 32 query rows read 32 adjacent floats
// of one key's column. A first version that read mask rows (each load
// touching 32 cache lines), with scalar shared-memory reads and chunks of
// 32 keys, took 0.586 ms at the tiled-eval shape in chip_smoke.py; this
// one 0.333 ms (SDPA 0.223 ms, on NVIDIA H100 80GB HBM3, 700 W). The one
// [L, L] mask is read by every block and stays in L2.
// The TPU kernel's head-masked stacked K/V ([L, heads*L, D], 8x the FLOPs)
// only keeps the TPU's matrix unit fed and is not carried over.
// A row whose mask is -inf everywhere gives 0/0 (NaN), as the twin's
// softmax does; EPIT's band masks never produce one, since every token's
// own position (the diagonal) lies inside its band.
// Tensor-core tiles (mma.sync / wgmma) are later work.
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
