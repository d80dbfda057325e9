// K6 — fused Swin-style window attention block.
//
// Replaces lfsr_tpu/ops/pallas_attention.py::_win_mha_kernel
// (window_mha_fused): for every ws x ws window of an [B, H, W, C] map,
//   ln  = LayerNorm(x)                      (centred two-pass variance)
//   q, k, v = ln @ Wqkv                     (q scaled by 1/sqrt(head_dim))
//   o_h = softmax(q_h k_h^T + bias_h) v_h   per head h
//   y   = x + attn_scale * (o @ Wout)
//
// What bounds it on this card: ~1.6 MFMA per 64-token window, 1.3 GFMA per
// call at the tiled-eval point ([2, 160, 160, 64], 800 windows) against
// ~13 MB of HBM traffic: the work is small matmuls whose operands live in
// shared memory, so shared-memory bandwidth and occupancy (one ~149 KB block
// per SM) bound it, not HBM.
//
// Design: one block per window. Wqkv and Wout are staged in shared memory;
// the LN output, q, k, v and one head's score tile stay in shared memory for
// the whole block, so nothing but x and y touches HBM. The TPU kernel's
// head-masked stacked K/V (pallas_attention.py:76-99) only exists to keep the
// TPU's 128-lane contraction full; here each head is computed directly on
// its head_dim slice. Rows of the [tokens][C] tiles are padded to C+1 floats
// so the k/v column reads of the score and PV loops are bank-conflict free.
// Register tiling and tensor cores (mma/wgmma) are later work.
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
