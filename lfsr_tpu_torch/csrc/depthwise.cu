// K11 — the flagship's depthwise convolutions outside the blocks, as one
// 2-D stencil kernel.
//
// Replaces no TPU kernel: JAX runs _dw_apply (lfsr_tpu/models/lfmambax.py:57)
// as XLA-fused shift-multiply-adds and LSFL's EPI convs (1x3 and 3x1,
// dilation angRes, groups = channels) as XLA grouped convolutions. In PyTorch
// the first was a chain of ~20 launches (a pad, 9 strided products, 8 adds,
// ~44 passes over the map) and the second cuDNN's grouped direct conv.
//
// For an NHWC map x [B, H, W, C] of the compute dtype T (float32 or bf16), a
// depthwise KH x KW kernel w [C, 1, KH, KW] (float32, rounded to T here, as
// .to(T) does), dilation (dh, dw) and zero 'same' padding:
//   "tap"  (rounding 0): each product rounded to T, the taps summed in
//          (ky, kx) order with a rounding after each add, the first tap taken
//          as is and the padding's products computed (signed zeros as the
//          chain's): the port's dw_apply chain bit for bit (float32:
//          __fmul_rn / __fadd_rn, which nvcc cannot contract into an fma;
//          bf16: lfsr::mul_rn_bf16x2 / add_rn_bf16x2, K7's taps);
//   "once" (rounding 1): the taps summed in float32 and rounded once to T,
//          as a convolution rounds (cuDNN's grouped conv's to within an ulp;
//          equal to it at every call chip_smoke and the tests make);
// then an optional bias [C] (rounded to T and added in T, as Conv.forward
// does).
//
// What bounds it on this card: a "tap" output costs 2 KH KW - 1 operations
// against 2 sizeof(T) bytes (one read, one write), far below the roofline's
// knee: bytes. At the flagship's LR map ([4, 720, 720, 64] bf16) that is
// 0.27 GB, 0.158 ms at 3.35 TB/s. The design reads each map once from HBM and
// writes it once, and keeps the arithmetic under the copies:
//  - persistent CTAs of 256 threads, two an SM (at most 128 registers a
//    thread), walk TH x TW output tiles of CS channels (all C of the
//    flagship's; a wider map in blocks of at most 2048), neighbouring CTAs on
//    neighbouring tiles, so the halo's second read comes from L2;
//  - a tile and its halo ((KH - 1) dh rows, (KW - 1) dw columns) are staged
//    in shared memory as [SH][SW][CS], pixels outside the image and channels
//    past C zero-filled (the padding): by cp.async, 16 bytes a copy, where C
//    is a multiple of 8, element by element otherwise. With two staged
//    tiles a CTA the next tile's copies fly while this one computes, with
//    one the SM's other CTA computes meanwhile (the wrapper's plan,
//    ops/depthwise.tile_plan: 8 x 32 with two at dilation 1, 16 x 32 with
//    one at dilation 3 in bf16);
//  - a thread owns 8 channels (its taps in registers as T) of a run of kRun
//    output rows down one column. At the row dilations of the flagship (a
//    template parameter: 1 and 3 for 3x3, 5 for 3x1) it reads each staged
//    input row of the run once, KW taps of 16 (bf16) or 32 bytes (a warp
//    reads 4 neighbouring pixels, 512 contiguous bytes at C 64 in bf16: no
//    bank conflicts), and gives the row to the KH outputs that take it, so
//    an output's taps still arrive in (ky, kx) order and the run's
//    accumulators stay in registers; at any other row dilation an output
//    reads its KH rows itself. Outputs go out as 16-byte (bf16) or 32-byte
//    stores where C is a multiple of 8, element by element otherwise.
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmemMax = 227 * 1024;
constexpr int kRun = 8;  // output rows an item (a thread's run down a column)
enum : int { kTap = 0, kOnce = 1 };

struct Params {
  const void* x;       // [B, H, W, C] of T
  const float* w;      // [C, KH, KW]
  const float* bias;   // [C], or null
  void* y;             // [B, H, W, C] of T
  int B, H, W, C, dh, dw;
  int CS;              // channels a staged tile (a multiple of 8)
  bool vec;            // C % 8 == 0: 16-byte copies and stores
  int TH, TW, SH, SW;  // output tile, staged tile (with the halo)
  int stages;          // staged tiles a CTA holds: 2 (the next one's copies in flight) or 1
  int rounding;
  lfsr::FastDiv gran;  // 16-byte granules a staged pixel
  lfsr::FastDiv cs;    // channels a staged pixel (CS)
  lfsr::FastDiv sw;    // staged columns
  lfsr::FastDiv tw;    // tile columns
  lfsr::FastDiv tx;    // tiles across
  lfsr::FastDiv tyx;   // tiles a channel block of an image
  lfsr::FastDiv ncb;   // channel blocks
};

// tile -> image b, first channel c0, first output row y0 and column x0
__device__ __forceinline__ void tile_origin(const Params& p, int tile, int& b, int& c0, int& y0,
                                            int& x0) {
  const int bc = p.tyx.div(tile), r = tile - bc * p.tyx.d;
  b = p.ncb.div(bc);
  c0 = (bc - b * p.ncb.d) * p.CS;
  const int ty = p.tx.div(r);
  y0 = ty * p.TH;
  x0 = (r - ty * p.tx.d) * p.TW;
}

// The tile's input and its halo -> the staged tile [SH][SW][CS], zeros
// outside the image and past C
template <typename T, int KH, int KW>
__device__ __forceinline__ void stage(const Params& p, T* dst, int tile) {
  int b, c0, y0, x0;
  tile_origin(p, tile, b, c0, y0, x0);
  const int top = y0 - (KH - 1) * p.dh / 2, left = x0 - (KW - 1) * p.dw / 2;
  const T* x = static_cast<const T*>(p.x);
  if (p.vec) {  // 16 bytes a copy: a granule lies wholly inside C or past it
    constexpr int kPer = 16 / sizeof(T);  // elements a granule
    const int n = p.SH * p.SW * p.gran.d;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int q = p.gran.div(i), c = c0 + (i - q * p.gran.d) * kPer;
      const int sy = p.sw.div(q), sx = q - sy * p.SW;
      const int gy = top + sy, gx = left + sx;
      const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && c < p.C;
      const T* src = in ? x + (((size_t)b * p.H + gy) * p.W + gx) * p.C + c : x;
      lfsr::cp_async16_zfill(dst + (size_t)q * p.CS + (c - c0), src, in);
    }
    return;
  }
  // element by element, as raw bits (a zero is +0, as F.pad's)
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned>::type;
  const Bits* xb = reinterpret_cast<const Bits*>(x);
  Bits* db = reinterpret_cast<Bits*>(dst);
  const int n = p.SH * p.SW * p.CS;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int q = p.cs.div(i), c = c0 + (i - q * p.CS);
    const int sy = p.sw.div(q), sx = q - sy * p.SW;
    const int gy = top + sy, gx = left + sx;
    const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && c < p.C;
    db[i] = in ? xb[(((size_t)b * p.H + gy) * p.W + gx) * p.C + c] : Bits(0);
  }
}

// A thread's values of 8 channels: bf16 as 4 bf16x2 words, float32 as 8 floats
template <typename T> struct Vec8 { float v[8]; };
template <> struct Vec8<bf16> { uint32_t v[4]; };
// An output's accumulator: "tap" keeps T ("once" in bf16 sums in float32)
template <typename T, bool kTapRound> struct Acc8 { float v[8]; };
template <> struct Acc8<bf16, true> { uint32_t v[4]; };

// 8 channels of a staged pixel (16 or 32 bytes)
template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* s) {
  Vec8<T> r;
  if constexpr (std::is_same<T, bf16>::value) {
    const uint4 q = *reinterpret_cast<const uint4*>(s);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
    r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  }
  return r;
}

// acc (+)= x w: "tap" rounds the product and the add to T, the first tap
// taken as is; "once" adds the float32 product to a float32 sum (from 0)
template <typename T, bool kTapRound>
__device__ __forceinline__ void tap(Acc8<T, kTapRound>& acc, const Vec8<T>& x, const Vec8<T>& w,
                                    bool first) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kTapRound) {
        const uint32_t t = lfsr::mul_rn_bf16x2(x.v[j], w.v[j]);
        acc.v[j] = first ? t : lfsr::add_rn_bf16x2(acc.v[j], t);
      } else {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.v[j]));
        const float2 wf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.v[j]));
        acc.v[2 * j] = fmaf(xf.x, wf.x, acc.v[2 * j]);
        acc.v[2 * j + 1] = fmaf(xf.y, wf.y, acc.v[2 * j + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kTapRound) {
        const float t = __fmul_rn(x.v[j], w.v[j]);
        acc.v[j] = first ? t : __fadd_rn(acc.v[j], t);
      } else {
        acc.v[j] = fmaf(x.v[j], w.v[j], acc.v[j]);
      }
    }
  }
}

// One item: 8 channels of kRun output rows of one column, from the staged
// tile at src (its first input row; rs the staged row stride, cs a tap's
// column step, in elements). At a row dilation DH > 0 (or a 1-row kernel)
// input row r (of kRun + (KH - 1) DH) is read once, KW taps, and feeds each
// output i = r - ky DH it belongs to; at DH 0 (the row dilation dh known at
// run time) output i reads rows i + ky dh itself. Either way an output's
// taps arrive in (ky, kx) order.
template <typename T, int KH, int KW, int DH, bool kTapRound>
__device__ __forceinline__ void item(const T* src, int rs, int cs, int dh,
                                     const Vec8<T> (&w)[KH * KW],
                                     Acc8<T, kTapRound> (&acc)[kRun]) {
  if constexpr (!kTapRound) {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i].v[j] = 0.f;
  }
  if constexpr (DH > 0 || KH == 1) {
    constexpr int D = KH == 1 ? 1 : DH, NR = kRun + (KH - 1) * D;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      Vec8<T> v[KW];
#pragma unroll
      for (int kx = 0; kx < KW; ++kx) v[kx] = load8(src + r * rs + kx * cs);
#pragma unroll
      for (int ky = 0; ky < KH; ++ky) {
        const int i = r - ky * D;
        if (i < 0 || i >= kRun) continue;
#pragma unroll
        for (int kx = 0; kx < KW; ++kx) tap(acc[i], v[kx], w[ky * KW + kx], ky == 0 && kx == 0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
#pragma unroll
      for (int ky = 0; ky < KH; ++ky)
#pragma unroll
        for (int kx = 0; kx < KW; ++kx)
          tap(acc[i], load8(src + (i + ky * dh) * rs + kx * cs), w[ky * KW + kx],
              ky == 0 && kx == 0);
  }
}

// an output's 8 channels in T with the bias added (in T), as 4 bf16x2 words
// or 8 floats
template <typename T, bool kTapRound>
__device__ __forceinline__ Vec8<T> finish(const Acc8<T, kTapRound>& acc, const Vec8<T>& bias,
                                          bool has_bias) {
  Vec8<T> o;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kTapRound) o.v[j] = acc.v[j];
      else o.v[j] = lfsr::pack_bf16(acc.v[2 * j], acc.v[2 * j + 1]);
      if (has_bias) o.v[j] = lfsr::add_rn_bf16x2(o.v[j], bias.v[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) o.v[j] = has_bias ? __fadd_rn(acc.v[j], bias.v[j]) : acc.v[j];
  }
  return o;
}

// 8 channels in T from float32 values at src[j stride] (zero past n)
template <typename T>
__device__ __forceinline__ Vec8<T> taps8(const float* src, int stride, int n) {
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = j < n ? src[(size_t)j * stride] : 0.f;
  Vec8<T> r;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) r.v[j] = lfsr::pack_bf16(f[2 * j], f[2 * j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) r.v[j] = f[j];
  }
  return r;
}

// the first n of 8 channels to dst: one 16- or 32-byte store where vec
template <typename T>
__device__ __forceinline__ void store8(T* dst, const Vec8<T>& o, bool vec, int n) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o.v[0], o.v[1], o.v[2], o.v[3]);
      return;
    }
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) d[j] = (unsigned short)(o.v[j / 2] >> (16 * (j % 2)));
  } else {
    if (vec) {
      float4* d = reinterpret_cast<float4*>(dst);
      d[0] = make_float4(o.v[0], o.v[1], o.v[2], o.v[3]);
      d[1] = make_float4(o.v[4], o.v[5], o.v[6], o.v[7]);
      return;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) dst[j] = o.v[j];
  }
}

template <typename T, int KH, int KW, int DH, bool kTapRound>
__global__ void __launch_bounds__(kThreads, 2) depthwise_kernel(const Params p) {
  constexpr int KK = KH * KW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = p.SH * p.SW * p.CS;
  T* const tiles = reinterpret_cast<T*>(smem);  // staged tiles, [stages][SH][SW][CS]

  // a thread: channel group g (8 channels of the block), lane l of P; an
  // item: a column of the tile and a run of kRun of its rows
  const int G = p.CS / 8, P = kThreads / G;
  const int g = threadIdx.x % G, l = threadIdx.x / G;
  const int cg = 8 * g;
  const int items = p.TW * (p.TH / kRun);
  const int rs = p.SW * p.CS, cs = p.dw * p.CS;
  const bool has_bias = p.bias != nullptr;

  Vec8<T> w[KK], bias;  // this thread's taps and bias in T, for channel block wc0
  int wc0 = -1;

  const int tiles_n = p.B * p.ncb.d * p.tyx.d;
  if ((int)blockIdx.x < tiles_n) stage<T, KH, KW>(p, tiles, blockIdx.x);
  lfsr::cp_async_commit();
  int cur = 0;
  for (int tile = blockIdx.x; tile < tiles_n; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (p.stages == 2) {  // the next tile's copies fly while this one computes
      if (next < tiles_n) stage<T, KH, KW>(p, tiles + (cur ^ 1) * tile_elems, next);
      lfsr::cp_async_commit();
      lfsr::cp_async_wait<1>();
    } else {  // one staged tile: the SM's other CTA computes while this one waits
      lfsr::cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed, for every thread's copies
    const T* xs = tiles + cur * tile_elems;
    int b, c0, y0, x0;
    tile_origin(p, tile, b, c0, y0, x0);
    const int nc = min(8, p.C - (c0 + cg));  // this thread's channels inside C
    if (l < P && nc > 0) {
      if (c0 != wc0) {  // a new channel block: its taps (once for the flagship's)
        wc0 = c0;
#pragma unroll
        for (int k = 0; k < KK; ++k) w[k] = taps8<T>(p.w + (size_t)(c0 + cg) * KK + k, KK, nc);
        if (has_bias) bias = taps8<T>(p.bias + c0 + cg, 1, nc);
      }
      for (int it = l; it < items; it += P) {
        const int seg = p.tw.div(it), px = it - seg * p.TW;
        const int gx = x0 + px, gy0 = y0 + seg * kRun;
        if (gx >= p.W || gy0 >= p.H) continue;
        const T* src = xs + (seg * kRun * p.SW + px) * p.CS + cg;
        T* dst = static_cast<T*>(p.y) + (((size_t)b * p.H + gy0) * p.W + gx) * p.C + c0 + cg;
        const size_t row = (size_t)p.W * p.C;
        const int rows = min(kRun, p.H - gy0);
        Acc8<T, kTapRound> acc[kRun];
        item<T, KH, KW, DH, kTapRound>(src, rs, cs, p.dh, w, acc);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          if (i >= rows) break;
          store8(dst + i * row, finish(acc[i], bias, has_bias), p.vec, nc);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
    if (p.stages == 2) {
      cur ^= 1;
    } else {
      if (next < tiles_n) stage<T, KH, KW>(p, tiles, next);
      lfsr::cp_async_commit();
    }
  }
}

template <typename T, int KH, int KW, int DH>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const size_t smem = (size_t)p.stages * p.SH * p.SW * p.CS * sizeof(T);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto* kernel = p.rounding == kTap ? depthwise_kernel<T, KH, KW, DH, true>
                                    : depthwise_kernel<T, KH, KW, DH, false>;
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
  const long long tiles = (long long)p.B * p.ncb.d * p.tyx.d;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// an instance for each row dilation of the flagship (3x3: 1 and 3; 3x1: 5,
// angRes), one for any other (DH 0: dh read at run time)
template <typename T>
cudaError_t dispatch(const Params& p, int kh, int kw, cudaStream_t s) {
  if (kh == 3 && kw == 3) {
    if (p.dh == 1) return launch<T, 3, 3, 1>(p, s);
    if (p.dh == 3) return launch<T, 3, 3, 3>(p, s);
    return launch<T, 3, 3, 0>(p, s);
  }
  if (kh == 3 && kw == 1) return p.dh == 5 ? launch<T, 3, 1, 5>(p, s) : launch<T, 3, 1, 0>(p, s);
  if (kh == 1 && kw == 3) return launch<T, 1, 3, 1>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [B, H, W, C] and y of dtype (0 float32, 1 bfloat16), contiguous (16-byte
// aligned where C % 8 == 0); w [C, 1, kh, kw] and bias [C] (or null)
// float32; (kh, kw) one of (3, 3), (1, 3), (3, 1); dilation (dh, dw) >= 1;
// channel blocks of cs channels (a multiple of 8 up to 8 x 256); output
// tiles of th x tw pixels, th a multiple of 8, 1 or 2 staged a CTA
// (ops/depthwise.tile_plan); rounding 0 "tap" / 1 "once".
LFSR_EXPORT int lfsr_depthwise(const void* x, const void* w, const void* bias, void* y, int B,
                               int H, int W, int C, int kh, int kw, int dh, int dw, int cs,
                               int th, int tw, int stages, int rounding, int dtype,
                               void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cs < 8 || cs % 8 || cs / 8 > kThreads ||
      cs > C + 7 || dh < 1 || dw < 1 || th < kRun || th % kRun || tw < 1 || stages < 1 ||
      stages > 2 || rounding < kTap || rounding > kOnce)
    return cudaErrorInvalidValue;
  if ((size_t)B * H * W * C >= (1ull << 40)) return cudaErrorInvalidValue;
  const int tiles_y = (H + th - 1) / th, tiles_x = (W + tw - 1) / tw, ncb = (C + cs - 1) / cs;
  if ((long long)B * ncb * tiles_y * tiles_x >= (1ll << 31)) return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.B = B; p.H = H; p.W = W; p.C = C; p.dh = dh; p.dw = dw;
  p.CS = cs;
  p.vec = C % 8 == 0;
  p.TH = th; p.TW = tw; p.stages = stages;
  p.SH = th + (kh - 1) * dh;
  p.SW = tw + (kw - 1) * dw;
  if ((long long)p.SH * p.SW * cs >= (1ll << 31)) return cudaErrorInvalidValue;
  p.rounding = rounding;
  const int item = dtype == lfsr::kBF16 ? 2 : 4;
  p.gran = lfsr::FastDiv(cs * item / 16);
  p.cs = lfsr::FastDiv(cs);
  p.sw = lfsr::FastDiv(p.SW);
  p.tw = lfsr::FastDiv(tw);
  p.tx = lfsr::FastDiv(tiles_x);
  p.tyx = lfsr::FastDiv(tiles_y * tiles_x);
  p.ncb = lfsr::FastDiv(ncb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfsr::kBF16) return dispatch<bf16>(p, kh, kw, s);
  if (dtype == lfsr::kF32) return dispatch<float>(p, kh, kw, s);
  return cudaErrorInvalidValue;
}
