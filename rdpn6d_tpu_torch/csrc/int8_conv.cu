// int8_conv: the W8A8 convolution of int8 serving, in two entry points.
//
//  * quantize: activations x, NCHW bfloat16 or float32 [B,C,H,W] -> xq, NHWC
//    int8 [B,H,W,Cp] with the channels zero-padded to Cp (a multiple of 32),
//    and the scale sx [B] float32. The scale is per sample (dynamic: the
//    absmax of the sample over C, H and W), a static calibrated scalar, or
//    the static scalar of the SmoothQuant-balanced activation (per-channel:
//    x is divided by t[c] * s).
//  * conv: xq ⊛ wq, with wq int8 [N][kh][kw][Cp] (scale sw [N] per output
//    channel), int32 accumulation, dequantized to out [B,N,Ho,Wo] NCHW in
//    bfloat16 or float32.
//
// Replaces rdpn6d_tpu/models/quant.py:42 Int8Conv (its quantization, :32
// quantize_symmetric and :103-155; the int32-accumulating XLA convolution,
// :131-133 and :146-148). Not a Pallas kernel: on the TPU it is an XLA int8
// convolution on the MXU.
//
// Arithmetic, op for op as the JAX package and the plain version
// (ops/int8_conv.py) compute it, so that all three agree bit for bit:
//  * s = max(amax, 1e-12) / 127 in float32 (__fdiv_rn);
//  * q = clip(rint(x / d), -127, 127) with d = s, or d = t[c] * s
//    (__fmul_rn, the product first, as quant.py:127), x / d by __fdiv_rn,
//    rintf rounding half to even as jnp.round does;
//  * y = float(acc) * (sx[b] * sw[n]) (the product first, quant.py:149-150
//    and :134), __int2float_rn and __fmul_rn, then __float2bfloat16_rn for
//    bfloat16 output. The build has no --use_fast_math.
//  * NaN as in XLA: a NaN in a sample makes its dynamic absmax, scale and
//    so its whole output NaN (jnp.max propagates it), and a NaN x / d
//    quantizes to 0 (XLA converts NaN to integer 0).
// The int32 sum is exact in any order: |acc| <= 127^2 * K, 4.6e7 at the
// largest K (2880) of the head, far from overflow.
//
// Bound, the lm13 head at the serving batch of 16 (M = 16 x 64 x 64 output
// pixels, N = 256): operations. 2 M N K int8 operations over 1,979 TOP/s
// dense (H100 SXM): K = 2880 (320 input channels, the first conv after the
// rot_concat skip) 96.6 GOP = 48.8 us; K = 2304 (256 -> 256) 77.3 GOP =
// 39.1 us. The bytes (xq and wq read once, bf16 out written once) take
// ~16 us at 3.35 TB/s either way.
//
// Design (simple and right first; wgmma, TMA and persistent tiles are later
// work):
//  * Implicit GEMM: M = B Ho Wo rows, N = Cout columns, K = kh kw Cp, in
//    k-tiles of 32 int8 (one tap's 32 channels: Cp is a multiple of 32, so
//    a k-tile never straddles two taps).
//  * A block of 256 threads (8 warps, 2 along M x 4 along N) owns a
//    128 x 128 output tile; a warp 64 x 32, as 4 x 4 tensor-core products
//    mma.sync.m16n8k32.s32.s8.s8.s32 per k-tile, 64 int32 accumulators a
//    thread.
//  * A tiles are gathered from the NHWC xq as im2col on the fly: a thread
//    copies 16 bytes of one output pixel's tap; taps in the padding, and
//    rows past M, are zero-filled by cp.async's src-size 0. B tiles are
//    rows of wq. Both go to shared memory by cp.async through kStages
//    buffers, so the copies of the next tiles run under this tile's
//    products.
//  * Shared rows are 48 bytes (32 + 16 of padding): the fragment loads
//    (a warp reads 8 rows x 4 words) hit 32 distinct banks.
//  * The epilogue writes NCHW directly: lanes of a warp cover 8
//    consecutive pixels of 4 channels, so bfloat16 stores use half of each
//    32-byte sector. Staging through shared memory is later work.
//  * The quantize kernel transposes NCHW to NHWC through a 32-channel x
//    32-pixel shared tile: reads along W and writes along C are coalesced.
//    The dynamic mode first reduces each sample's absmax over blocks into
//    an unsigned word by atomicMax: |x| orders as its bits, and a NaN's
//    bits order above every other value's, so the max propagates NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kCinAlign = 32;     // channel padding of xq and wq: one k-tile
// quantize
constexpr int kQTile = 32;        // pixels along W and channels a block tile
constexpr int kQThreads = 256;
constexpr int kAmaxThreads = 256;
constexpr int kAmaxMaxBlocks = 64;   // blocks a sample's absmax at most
// conv
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;           // bytes of K a stage holds: one k-tile
constexpr int kStages = 3;
constexpr int kConvThreads = 256;
constexpr int kRowBytes = 48;     // a shared row: 32 bytes + 16 of padding
constexpr int kWarpsN = 4;
constexpr int kMTiles = 4;        // m16 tiles a warp: 64 rows
constexpr int kNTiles = 4;        // n8 tiles a warp: 32 columns

enum Mode { kDynamic = 0, kStatic = 1, kPerChannel = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- quantize

template <typename T>
__global__ void __launch_bounds__(kAmaxThreads)
    absmax_kernel(const T* __restrict__ x, long long per_sample,
                  unsigned* __restrict__ amax_bits) {
  const T* xs = x + (size_t)blockIdx.y * per_sample;
  // the max of the bits of |x|: the float max, with NaN above all
  unsigned m = 0u;
  for (long long i = (long long)blockIdx.x * kAmaxThreads + threadIdx.x;
       i < per_sample; i += (long long)gridDim.x * kAmaxThreads)
    m = max(m, __float_as_uint(fabsf(to_f32(xs[i]))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned warp_max[kAmaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kAmaxThreads / 32 ? warp_max[threadIdx.x] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(&amax_bits[blockIdx.y], m);
  }
}

// Block (w-tile, h, b): 32 pixels of row h of sample b, every channel tile.
// amax: [B] (dynamic) or [1]; t: [C] (per-channel) or unused.
template <typename T, int kMode>
__global__ void __launch_bounds__(kQThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                    const float* __restrict__ t, int8_t* __restrict__ xq,
                    float* __restrict__ sx, int C, int H, int W, int Cp) {
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * kQTile;
  const float a = kMode == kDynamic ? amax[b] : amax[0];
  // max(a, 1e-12) keeping a NaN, as jnp.maximum does (fmaxf drops it)
  const float s = __fdiv_rn(a != a ? a : fmaxf(a, 1e-12f), 127.0f);
  if (blockIdx.x == 0 && h == 0 && threadIdx.x == 0) sx[b] = s;
  __shared__ int8_t tile[kQTile][kQTile + 4];   // [channel][pixel]
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  const T* xr = x + (size_t)b * C * plane + (size_t)h * W;
  int8_t* out = xq + ((size_t)b * H + h) * W * (size_t)Cp;
  const int p = threadIdx.x >> 3, g = threadIdx.x & 7;   // write: pixel, word
  for (int c0 = 0; c0 < Cp; c0 += kQTile) {
    for (int cc = ty; cc < kQTile; cc += kQThreads / 32) {
      const int c = c0 + cc, w = w0 + tx;
      float q = 0.f;
      if (c < C && w < W) {
        const float v = to_f32(xr[(size_t)c * plane + w]);
        const float d = kMode == kPerChannel ? __fmul_rn(t[c], s) : s;
        const float r = rintf(__fdiv_rn(v, d));
        q = r != r ? 0.f : fminf(fmaxf(r, -127.f), 127.f);   // NaN -> 0
      }
      tile[cc][tx] = (int8_t)(int)q;
    }
    __syncthreads();
    if (w0 + p < W) {
      const uint32_t word = (uint32_t)(uint8_t)tile[4 * g][p] |
                            (uint32_t)(uint8_t)tile[4 * g + 1][p] << 8 |
                            (uint32_t)(uint8_t)tile[4 * g + 2][p] << 16 |
                            (uint32_t)(uint8_t)tile[4 * g + 3][p] << 24;
      *reinterpret_cast<uint32_t*>(out + (size_t)(w0 + p) * Cp + c0 + 4 * g) =
          word;
    }
    __syncthreads();
  }
}

// -------------------------------------------------------------------- conv

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

struct ConvShape {
  int B, H, W, Cp, N, kh, kw, stride, pad, Ho, Wo;
};

// Grid (ceil(M / kBM), ceil(N / kBN)); block kConvThreads.
template <typename TOut>
__global__ void __launch_bounds__(kConvThreads)
    int8_conv_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ sx,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ sw, TOut* __restrict__ out,
                     ConvShape sh) {
  __shared__ __align__(16) int8_t As[kStages][kBM][kRowBytes];
  __shared__ __align__(16) int8_t Bs[kStages][kBN][kRowBytes];

  const int tid = threadIdx.x;
  const int hw = sh.Ho * sh.Wo;
  const long long M = (long long)sh.B * hw;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int slabs = sh.Cp / kCinAlign;
  const int KT = sh.kh * sh.kw * slabs;
  const long long K = (long long)KT * kBK;

  // the A row and B row this thread copies: 2 threads a row, 16 B each
  const int row = tid >> 1, half = tid & 1;
  const long long m = m0 + row;
  const bool m_ok = m < M;
  int iy0 = 0, ix0 = 0;
  const int8_t* xb = xq;
  if (m_ok) {
    const int b = (int)(m / hw);
    const int r = (int)(m - (long long)b * hw);
    const int oy = r / sh.Wo, ox = r - oy * sh.Wo;
    iy0 = oy * sh.stride - sh.pad;
    ix0 = ox * sh.stride - sh.pad;
    xb = xq + (size_t)b * sh.H * sh.W * sh.Cp;
  }
  const int n_row = n0 + row;
  const bool n_ok = n_row < sh.N;
  const int8_t* wrow = wq + (n_ok ? (size_t)n_row * K : 0);

  auto load = [&](int stage, int kt) {
    const int tap = kt / slabs;
    const int c0 = (kt - tap * slabs) * kCinAlign + 16 * half;
    const int ky = tap / sh.kw, kx = tap - ky * sh.kw;
    const int iy = iy0 + ky, ix = ix0 + kx;
    const bool a_ok = m_ok && iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W;
    const int8_t* a_src =
        a_ok ? xb + ((size_t)iy * sh.W + ix) * sh.Cp + c0 : xq;
    cp_async16(&As[stage][row][16 * half], a_src, a_ok);
    const int8_t* b_src =
        n_ok ? wrow + (size_t)kt * kBK + 16 * half : wq;
    cp_async16(&Bs[stage][row][16 * half], b_src, n_ok);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / kWarpsN) * (kMTiles * 16);
  const int wn = (warp % kWarpsN) * (kNTiles * 8);
  const int gid = lane >> 2, tig = lane & 3;

  int acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load(next % kStages, next);
    cp_async_commit();

    const int st = kt % kStages;
    unsigned af[kMTiles][4], bf[kNTiles][2];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const int r = wm + i * 16 + gid;
      af[i][0] = lds32(&As[st][r][tig * 4]);
      af[i][1] = lds32(&As[st][r + 8][tig * 4]);
      af[i][2] = lds32(&As[st][r][16 + tig * 4]);
      af[i][3] = lds32(&As[st][r + 8][16 + tig * 4]);
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int c = wn + j * 8 + gid;
      bf[j][0] = lds32(&Bs[st][c][tig * 4]);
      bf[j][1] = lds32(&Bs[st][c][16 + tig * 4]);
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // epilogue: acc[i][j] = rows (gid, gid + 8) x columns (2 tig, 2 tig + 1)
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long mm = m0 + wm + i * 16 + gid + 8 * hf;
      if (mm >= M) continue;
      const int b = (int)(mm / hw);
      const int p = (int)(mm - (long long)b * hw);
      const float sxb = sx[b];
      TOut* ob = out + (size_t)b * sh.N * hw + p;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * tig + e;
          if (n >= sh.N) continue;
          const float scale = __fmul_rn(sxb, sw[n]);
          store(ob + (size_t)n * hw,
                __fmul_rn(__int2float_rn(acc[i][j][2 * hf + e]), scale));
        }
      }
    }
  }
}

// Makes `device` current for `launch` and restores the caller's device.
template <typename F>
int on_device(int device, F launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

template <typename T>
cudaError_t quantize(const T* x, int mode, const float* amax, const float* t,
                     unsigned* amax_scratch, int8_t* xq, float* sx, int B,
                     int C, int H, int W, int Cp, cudaStream_t s) {
  if (mode == kDynamic) {
    const long long per_sample = (long long)C * H * W;
    long long blocks = (per_sample + 16 * kAmaxThreads - 1) /
                       (16 * kAmaxThreads);
    blocks = blocks < 1 ? 1 : blocks > kAmaxMaxBlocks ? kAmaxMaxBlocks : blocks;
    absmax_kernel<T><<<dim3((unsigned)blocks, B), kAmaxThreads, 0, s>>>(
        x, per_sample, amax_scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    amax = reinterpret_cast<const float*>(amax_scratch);
  }
  const dim3 grid((W + kQTile - 1) / kQTile, H, B);
  if (mode == kDynamic)
    quantize_kernel<T, kDynamic><<<grid, kQThreads, 0, s>>>(x, amax, t, xq, sx,
                                                            C, H, W, Cp);
  else if (mode == kStatic)
    quantize_kernel<T, kStatic><<<grid, kQThreads, 0, s>>>(x, amax, t, xq, sx,
                                                           C, H, W, Cp);
  else
    quantize_kernel<T, kPerChannel><<<grid, kQThreads, 0, s>>>(
        x, amax, t, xq, sx, C, H, W, Cp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B,C,H,W] bfloat16 (x_bf16 = 1) or float32; mode 0 dynamic (amax_scratch
// [B] zeroed by the caller), 1 static (amax [1]), 2 per-channel (amax [1],
// t [C]); xq [B,H,W,Cp]; sx [B]. Returns a cudaError_t as an int.
int int8_quantize_launch(const void* x, int x_bf16, int mode,
                         const float* amax, const float* t,
                         unsigned* amax_scratch, int8_t* xq, float* sx, int B,
                         int C, int H, int W, int Cp, int device,
                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C <= 0 || Cp < C || Cp % kCinAlign != 0 || mode < 0 || mode > 2 ||
      H > 65535 || B > 65535 || (mode == kDynamic && amax_scratch == nullptr) ||
      (mode != kDynamic && amax == nullptr) ||
      (mode == kPerChannel && t == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return x_bf16 ? quantize(static_cast<const __nv_bfloat16*>(x), mode, amax,
                             t, amax_scratch, xq, sx, B, C, H, W, Cp, s)
                  : quantize(static_cast<const float*>(x), mode, amax, t,
                             amax_scratch, xq, sx, B, C, H, W, Cp, s);
  });
}

// xq [B,H,W,Cp] int8, sx [B], wq [N,kh,kw,Cp] int8, sw [N] -> out
// [B,N,Ho,Wo] bfloat16 (out_bf16 = 1) or float32. Returns a cudaError_t as
// an int.
int int8_conv_launch(const int8_t* xq, const float* sx, const int8_t* wq,
                     const float* sw, void* out, int out_bf16, int B, int H,
                     int W, int Cp, int N, int kh, int kw, int stride, int pad,
                     int Ho, int Wo, int device, void* stream) {
  if (B <= 0 || N <= 0 || Ho <= 0 || Wo <= 0) return 0;
  const long long M = (long long)B * Ho * Wo;
  const long long m_blocks = (M + kBM - 1) / kBM;
  if (Cp <= 0 || Cp % kCinAlign != 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      pad < 0 || (Ho - 1) * stride - pad + kh > H + pad ||
      (Wo - 1) * stride - pad + kw > W + pad || m_blocks > INT_MAX ||
      (N + kBN - 1) / kBN > 65535 || (long long)Ho * Wo > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const ConvShape sh{B, H, W, Cp, N, kh, kw, stride, pad, Ho, Wo};
  const dim3 grid((unsigned)m_blocks, (N + kBN - 1) / kBN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (out_bf16)
      int8_conv_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, s>>>(
          xq, sx, wq, sw, static_cast<__nv_bfloat16*>(out), sh);
    else
      int8_conv_kernel<float><<<grid, kConvThreads, 0, s>>>(
          xq, sx, wq, sw, static_cast<float*>(out), sh);
    return cudaGetLastError();
  });
}

const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
