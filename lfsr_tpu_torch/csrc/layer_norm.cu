// K13 — LayerNorm over the last axis (flax's: float32 statistics, the fast
// variance), with the add of a position code before it folded in: LFT's 16
// LayerNorms a forward (AngTrans and SpaTrans, two a block each) and EPIT's
// two a transformer.
//
// Replaces no TPU kernel: JAX runs flax's LayerNorm, and the add of the code
// before it, as XLA ops. In PyTorch the same function was a chain of ~14
// launches in float32 (a cast, two means, the square, the variance's
// subtraction and clamp, + eps, rsqrt, rsqrt x gamma, x - mean, the product,
// + beta, the cast back; the add of the code one launch more), each a whole
// pass over the token map.
//
// For x [R, C] (R the rows of [..., P, C]) of dtype TX, an optional addend
// [P, C] of dtype TA (row r takes addend row r mod P), gamma, beta [C]
// float32, and the output dtype TO:
//   s    = x + add, in torch's promotion: TX = TA = bf16 rounds the sum to
//          bf16 (SpaTrans's embedded code), any float32 operand keeps it in
//          float32 (AngTrans's code);
//   mean = sum(s) / C, var = max(sum(s s) / C - mean mean, 0);
//   out  = TO((s - mean) (rsqrt(var + eps) gamma) + beta).
// Every float32 operation is the twin's (ops/layer_norm.layer_norm_plain, the
// chain of ops/cross_scan.layer_norm_fast), each rounded as torch rounds it
// (__fmul_rn / __fadd_rn / __fsub_rn, so nvcc fuses none into an fma); only
// the order of the two sums over C differs.
//
// What bounds it on this card: ~8 float32 operations an element against
// 2 sizeof(T) bytes (one read, one write): ~1 operation a byte, far below the
// ~295 of the roofline's knee. Bytes. At SpaTrans's call ([400, 1024, 128]
// bf16) that is 210 MB, 0.063 ms at 3.35 TB/s. The design reads the tokens
// once and writes the output once, and keeps enough bytes in flight:
//  - a row is C / 8 lanes (rounded up to a power of two, at most 32) of one
//    16-byte vector each (8 bf16; a float32 x takes two 16-byte loads for its
//    8 values): 8 lanes at C 64 (4 rows a warp), 16 at C 128 (2 rows a warp);
//    a wider row puts V = 2 or 4 vectors on each of 32 lanes (C up to 1024);
//  - a lane keeps its gamma / beta slice in registers for every row it
//    visits, and loads the matching 16 bytes of its row's addend row, which
//    is small (at most 256 KB at LFT's calls) and stays in L2;
//  - persistent CTAs of 256 threads, as many an SM as fit, walk the rows a
//    warp tile at a time (neighbouring warps on neighbouring tiles); a tile
//    is 4 / V rows a lane, whose loads are all issued before the first
//    reduction (at C 64 bf16: 64 bytes a lane, ~32 KB an SM in flight);
//  - sum(s) and sum(s s) go together through one butterfly of shuffles over
//    the row's lanes; x is read with the streaming hint (read once), and each
//    lane writes its 8 outputs with one 16-byte store (two for float32).
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels a lane's vector
enum : int { kNoAdd = -1 };

struct Params {
  const void* x;        // [R, C] of TX
  const void* add;      // [P, C] of TA, or null
  const float* gamma;   // [C]
  const float* beta;    // [C]
  void* out;            // [R, C] of TO
  long long rows;       // R
  long long tiles;      // warp tiles: R / (rows a tile), rounded up
  int C;
  int chunks;           // C / 8: vectors a row
  int log_group;        // lanes a row = 1 << log_group (chunks rounded up to a power of two, <= 32)
  lfsr::FastDiv period; // P
  float inv_c;          // 1 / C
  float eps;
};

// 8 consecutive values of T as registers
template <typename T> struct Vec8;
template <> struct Vec8<bf16> { uint4 u; };
template <> struct Vec8<float> { float4 a, b; };

__device__ __forceinline__ void zero(Vec8<bf16>& v) { v.u = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(Vec8<float>& v) {
  v.a = make_float4(0.f, 0.f, 0.f, 0.f);
  v.b = v.a;
}

// x: read once, streaming; the addend: the read-only path (it is read by
// every period of rows and stays in L2)
__device__ __forceinline__ void load_stream(Vec8<bf16>& v, const bf16* p) {
  v.u = __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_stream(Vec8<float>& v, const float* p) {
  v.a = __ldcs(reinterpret_cast<const float4*>(p));
  v.b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void load_cached(Vec8<bf16>& v, const bf16* p) {
  v.u = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_cached(Vec8<float>& v, const float* p) {
  v.a = __ldg(reinterpret_cast<const float4*>(p));
  v.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

// bf16 -> float32 is exact: the 16 bits shifted up
__device__ __forceinline__ void unpack(const Vec8<bf16>& v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.u.x, v.u.y, v.u.z, v.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const Vec8<float>& v, float (&f)[kVec]) {
  f[0] = v.a.x; f[1] = v.a.y; f[2] = v.a.z; f[3] = v.a.w;
  f[4] = v.b.x; f[5] = v.b.y; f[6] = v.b.z; f[7] = v.b.w;
}

// 8 outputs, rounded to nearest even where TO is bf16 (torch's .to)
__device__ __forceinline__ void store8(bf16* p, const float (&f)[kVec]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(lfsr::pack_bf16(f[0], f[1]), lfsr::pack_bf16(f[2], f[3]),
                                            lfsr::pack_bf16(f[4], f[5]), lfsr::pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// V vectors a lane (1 up to C 256, 2 up to 512, 4 up to 1024), 4 / V rows a
// lane a tile. TA is void without an addend.
template <typename TX, typename TA, typename TO, int V>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(const Params p) {
  constexpr int U = 4 / V;
  constexpr bool kAdd = !std::is_void<TA>::value;
  // the addend's storage type (unused without one)
  using TS = typename std::conditional<kAdd, TA, TX>::type;
  // bf16 + bf16 rounds to bf16; a float32 operand keeps the sum in float32
  constexpr bool kRoundSum =
      kAdd && std::is_same<TX, bf16>::value && std::is_same<TS, bf16>::value;

  const int lane = threadIdx.x & 31;
  const int group = 1 << p.log_group;
  const int sub = lane & (group - 1);       // the lane's place in its row's group
  const int slot = lane >> p.log_group;     // its row in a warp step
  const int step_rows = 32 >> p.log_group;  // rows a warp step
  const long long tile_rows = (long long)U * step_rows;

  // the lane's channels: vector j = sub + v * group, channels 8 j .. 8 j + 7
  float g[V][kVec], b[V][kVec];
  bool has[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = sub + v * group;
    has[v] = j < p.chunks;
    Vec8<float> gv, bv;
    zero(gv);
    zero(bv);
    if (has[v]) {
      load_cached(gv, p.gamma + j * kVec);
      load_cached(bv, p.beta + j * kVec);
    }
    unpack(gv, g[v]);
    unpack(bv, b[v]);
  }

  const TX* x = static_cast<const TX*>(p.x);
  const TS* a = static_cast<const TS*>(p.add);
  TO* out = static_cast<TO*>(p.out);
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32; t < p.tiles;
       t += warps) {
    // every load of the tile first
    Vec8<TX> xr[U][V];
    Vec8<TS> ar[U][V];
    long long row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = t * tile_rows + u * step_rows + slot;
      const bool ok = row[u] < p.rows;
      const int pr = ok && kAdd ? (int)row[u] - p.period.d * p.period.div((int)row[u]) : 0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c0 = (sub + v * group) * kVec;
        zero(xr[u][v]);
        if (ok && has[v]) load_stream(xr[u][v], x + row[u] * p.C + c0);
        if constexpr (kAdd) {
          zero(ar[u][v]);
          if (ok && has[v]) load_cached(ar[u][v], a + (long long)pr * p.C + c0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s[V][kVec];
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        unpack(xr[u][v], s[v]);
        if constexpr (kAdd) {
          float av[kVec];
          unpack(ar[u][v], av);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            s[v][i] = __fadd_rn(s[v][i], av[i]);
            if constexpr (kRoundSum) s[v][i] = lfsr::round_bf16(s[v][i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          sum = __fadd_rn(sum, s[v][i]);
          sq = __fadd_rn(sq, __fmul_rn(s[v][i], s[v][i]));
        }
      }
      // the row's lanes are an aligned group: the butterfly stays inside it
      for (int o = group >> 1; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      const float mean = __fmul_rn(sum, p.inv_c);
      const float var = fmaxf(__fsub_rn(__fmul_rn(sq, p.inv_c), __fmul_rn(mean, mean)), 0.f);
      const float r = rsqrtf(__fadd_rn(var, p.eps));
      if (row[u] >= p.rows) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!has[v]) continue;
        float y[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          y[i] = __fadd_rn(__fmul_rn(__fsub_rn(s[v][i], mean), __fmul_rn(r, g[v][i])), b[v][i]);
        store8(out + row[u] * p.C + (sub + v * group) * kVec, y);
      }
    }
  }
}

template <typename TX, typename TA, typename TO, int V>
cudaError_t launch(const Params& p, cudaStream_t s) {
  auto* kernel = layer_norm_kernel<TX, TA, TO, V>;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ctas = (p.tiles + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(ctas < (long long)sms * per_sm ? ctas : (long long)sms * per_sm);
  kernel<<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TA, typename TO>
cudaError_t by_width(Params& p, cudaStream_t s) {
  const int V = p.chunks <= 32 ? 1 : p.chunks <= 64 ? 2 : 4;
  p.tiles = (p.rows + (4 / V) * (32 >> p.log_group) - 1) / ((4 / V) * (32 >> p.log_group));
  if (V == 1) return launch<TX, TA, TO, 1>(p, s);
  if (V == 2) return launch<TX, TA, TO, 2>(p, s);
  return launch<TX, TA, TO, 4>(p, s);
}

template <typename TX, typename TA>
cudaError_t by_out(Params& p, int out_dtype, cudaStream_t s) {
  if (out_dtype == lfsr::kBF16) return by_width<TX, TA, bf16>(p, s);
  if (out_dtype == lfsr::kF32) return by_width<TX, TA, float>(p, s);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t by_add(Params& p, int add_dtype, int out_dtype, cudaStream_t s) {
  if (add_dtype == kNoAdd) return by_out<TX, void>(p, out_dtype, s);
  if (add_dtype == lfsr::kBF16) return by_out<TX, bf16>(p, out_dtype, s);
  if (add_dtype == lfsr::kF32) return by_out<TX, float>(p, out_dtype, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [rows, C] (the rows of [..., P, C]) of x_dtype, add [P, C] of add_dtype
// (-1: no addend, add null), gamma and beta [C] float32, out [rows, C] of
// out_dtype (0 float32, 1 bfloat16); all contiguous and 16-byte aligned;
// C a multiple of 8 up to 1024, 1 <= period, rows < 2^31.
LFSR_EXPORT int lfsr_layer_norm(const void* x, const void* add, const void* gamma,
                                const void* beta, void* out, long long rows, int C, int period,
                                float eps, int x_dtype, int add_dtype, int out_dtype,
                                void* stream) {
  if (rows < 0 || rows >= (1ll << 31) || C < kVec || C % kVec || C > 32 * 4 * kVec ||
      period < 1 || (add_dtype != kNoAdd) != (add != nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  Params p{};
  p.x = x;
  p.add = add;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = out;
  p.rows = rows;
  p.C = C;
  p.chunks = C / kVec;
  p.log_group = 0;
  while ((1 << p.log_group) < p.chunks && p.log_group < 5) ++p.log_group;
  p.period = lfsr::FastDiv(period);
  p.inv_c = 1.0f / (float)C;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == lfsr::kBF16) return by_add<bf16>(p, add_dtype, out_dtype, s);
  if (x_dtype == lfsr::kF32) return by_add<float>(p, add_dtype, out_dtype, s);
  return cudaErrorInvalidValue;
}
