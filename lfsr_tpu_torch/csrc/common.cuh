// Shared helpers for the lfsr_tpu_torch Hopper kernels.
//
// Every kernel keeps its arithmetic in float32 and converts at the load and
// store, so one template covers float32 and bfloat16 I/O. The C entry points
// (LFSR_EXPORT) take raw device pointers, sizes, a dtype code (0 = float32,
// 1 = bfloat16) and a cudaStream_t, launch, and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define LFSR_EXPORT extern "C" __attribute__((visibility("default")))

namespace lfsr {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// round to nearest even, the same rounding as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22, results
// below 2^-126 flushed to 0); exp2f wraps the same instruction in range
// fix-ups that cost more than it where a loop is bound by issue
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- tensor-core helpers (mma.sync m16n8k16, bf16 operands, f32 sums) ----
// Fragments (PTX ISA, g = lane / 4, t = lane % 4): a0 (row g, k 2t..2t+1),
// a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t..2t+1,
// col g), b1 (k 2t + 8.., g); d0, d1 (row g, cols 2t, 2t + 1), d2, d3 (row
// g + 8, same). Two bf16 values per 32-bit register, the lower index low.

// two adjacent bf16 as one 32-bit register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned). Register i holds
// matrix i in the fragment layout above (thread (g, t): row g, columns 2t,
// 2t + 1); with kTrans each matrix is transposed on the way (row 2t and
// 2t + 1, column g), which makes a B fragment of a row-major [k][n] tile.
template <bool kTrans = false>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Two 8x8 bf16 matrices: lanes 0-15 give the row addresses (lane l: row
// l % 8 of matrix l / 8); the other lanes' addresses are not read
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// acc[nt] += a . B over the 16 k of this step, for all NT n-tiles, with B
// held transposed in shared memory (bt: row n is output column n, k0 the
// step's first k, ld the row pitch: 16 x an odd number of bytes keeps it
// conflict-free); one ldmatrix.x4 gives the B fragments of two n-tiles
template <int NT>
__device__ __forceinline__ void mma_bt(float (&acc)[NT][4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* bt, int ld, int k0, int lane) {
  static_assert(NT % 2 == 0, "n-tiles go in pairs");
  // lane l: row l % 8 of matrix l / 8 = (n-tile pair half l / 16, k half (l / 8) % 2)
  const __nv_bfloat16* p =
      bt + (((lane >> 4) << 3) + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, p + nt * 8 * ld);
    mma_bf16(acc[nt], a, b[0], b[1]);
    mma_bf16(acc[nt + 1], a, b[2], b[3]);
  }
}

// two floats rounded to bf16 and packed, the first low
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes global -> shared without a register round trip (cp.async.cg);
// complete with cp_async_wait_all() and a barrier
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}
// 16 bytes global -> shared, or 16 zero bytes where !valid (src-size 0:
// nothing is read; gmem must still be a valid address)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(valid ? 16 : 0));
}
// 8 bytes global -> shared (the .ca form: .cg takes 16 bytes only)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}
// close the thread's copies issued since the last commit into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most kPending of the thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A 4 x 4 transpose inside each quad (t = lane % 4): lane t holds v[k] =
// M[t][k] on entry and M[k][t] on return. Applied to an mma accumulator's
// values for 4 consecutive n-tiles, it leaves lane t with the 8 columns of
// n-tile t (columns 2k, 2k + 1 in v[k]): one 16-byte granule of a row.
// Every lane of the warp must take part.
template <typename V>
__device__ __forceinline__ void quad_transpose(V (&v)[4], int t) {
  V s0 = (t & 2) ? v[0] : v[2], s1 = (t & 2) ? v[1] : v[3];
  V r0 = __shfl_xor_sync(0xffffffffu, s0, 2), r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (t & 2) { v[0] = r0; v[1] = r1; } else { v[2] = r0; v[3] = r1; }
  s0 = (t & 1) ? v[0] : v[1];
  s1 = (t & 1) ? v[2] : v[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (t & 1) { v[0] = r0; v[2] = r1; } else { v[1] = r0; v[3] = r1; }
}

// a * b and a + b on bf16x2, each rounded once to nearest even (PyTorch's
// bf16 multiply and add). The .rn modifier matters: ptxas may fuse an
// unmodified bf16x2 mul and add (what __hmul2/__hadd2 emit) into one fma,
// which rounds once for both.
__device__ __forceinline__ uint32_t mul_rn_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_rn_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// float -> bf16 -> float (round to nearest even)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16x3's split of two floats: hi = (bf16(a), bf16(b)) packed, lo = the
// rests (a - hi_a, b - hi_b) rounded to bf16 and packed, the first low
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a . b with 16 of float32's 24 mantissa bits (bf16x3): a_lo b_hi +
// a_hi b_lo + a_hi b_hi, each summed in float32; both operands come split
// (split_bf16x2). Relative error ~2^-17 a product
__device__ __forceinline__ void mma_3xbf16(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_bf16(d, a_lo, b0_hi, b1_hi);
  mma_bf16(d, a_hi, b0_lo, b1_lo);
  mma_bf16(d, a_hi, b0_hi, b1_hi);
}

// ---- the scans' lane plans (csrc/scan_chunked.cu, scan_adjoint.cu, scan.cu) ----
// Lanes per channel of the chunk-parallel scans (K1/K2 and K3's summaries)
// at N states, each lane holding N / P of them; the sum over n takes
// log2(P) shuffles. A power of two, so a channel's P lanes are one shuffle
// butterfly: 1 up to N 8, 2 at 16 and 24 (12 states a lane: B and C still
// read 4 at a time), 4 at 32.
__host__ __device__ constexpr int scan_lanes(int N) { return N <= 8 ? 1 : N <= 24 ? 2 : N / 8; }
// Lanes a channel spans in the one-warp layouts (lane = (channel, n): K3's
// adjoint pass, csrc/scan.cu): N rounded up to a power of two, so 32 at
// N 24, where lanes n >= 24 hold h = 0 and add 0 to every sum over n.
__host__ __device__ constexpr int state_span(int N) {
  return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32;
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 in 32-bit integer arithmetic:
// umulhi(n, m) >> s with m = ceil(2^(31 + l) / d), l = ceil(log2 d), s =
// l - 1 (Granlund-Montgomery, as CUTLASS's FastDivmod); d = 1 passes n.
// Made on the host, so a kernel's loops divide by a runtime H or W without
// the tens of instructions of a software division.
struct FastDiv {
  int d;
  unsigned m;
  int s;
  FastDiv() = default;
  __host__ explicit FastDiv(int d_) : d(d_), m(0), s(0) {
    if (d_ > 1) {
      int l = 0;
      while ((1ll << l) < d_) ++l;
      m = (unsigned)(((1ull << (31 + l)) + (unsigned)d_ - 1) / (unsigned)d_);
      s = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, m) >> s);
  }
};

// allow a kernel more than the default 48 KB of dynamic shared memory
inline cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace lfsr
