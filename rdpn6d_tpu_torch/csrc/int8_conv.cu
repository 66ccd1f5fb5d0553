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
// Design (simple and right first; TMA, a staged halo, warp specialisation
// and persistent tiles are later work):
//  * Implicit GEMM: M = B Ho Wo rows, N = Cout columns, K = kh kw Cp. A is
//    the im2col of the NHWC xq and B is wq [N][K]: both K-major, the only
//    layout wgmma takes for 8-bit operands.
//  * A block of 256 threads, two warpgroups, owns a 128 x BN output tile
//    (BN 256, 128 or 64 and the stage count from ops/int8_conv.py's
//    int8_conv_plan, passed in and checked); each warpgroup issues
//    wgmma.mma_async.m64nBNk32.s32.s8.s8 on its 64 rows with both operands
//    in shared memory, BN / 2 int32 accumulators a thread.
//  * K goes in slabs of 128 bytes (four k32 wgmmas) through a ring of
//    kStages buffers in dynamic shared memory, filled by cp.async from all
//    256 threads. Each 16-byte chunk has its own tap and channel, advanced
//    from its k offset slab by slab (Cp is a multiple of 32, so no chunk
//    straddles a tap); a tap in the padding, a row past M or N and a chunk
//    past K are zero-filled by cp.async's src-size 0. The loader's work
//    sits between two barriers, so it is kept short: each A row's origin
//    in xq is computed once, a slab adds one tap offset and tests two
//    bounds a row.
//  * Shared layout: wgmma's canonical K-major layout with the 128-byte
//    swizzle: tile row r's 128 bytes of the slab at r 128, its 16-byte
//    chunk c at (c ^ r % 8) 16, so the eight rows of an 8-row group put a
//    chunk on eight distinct bank quarters. The descriptor's stride byte
//    offset (SBO) steps between 8-row groups; a k32 step moves its start
//    address by 32 bytes (PTX ISA, "Matrix Descriptor Format").
//    tests/test_torch_int8_plan.py places the chunks and reads them back
//    through these constants in numpy. Without a swizzle (core matrices of
//    8 x 16 bytes, 128 bytes apart along K) wgmma's reads fall on the same
//    banks. A warp's 32 chunks fill 512 contiguous bytes: no bank
//    conflicts on the copies.
//  * A slab: cp.async.wait_group; fence.proxy.async (cp.async writes
//    through the generic proxy, wgmma reads through the async proxy);
//    __syncthreads; the slab's wgmmas, committed as one group; the copies
//    of the slab kStages - 2 ahead, into the buffer of slab kt - 2, whose
//    wgmmas every warpgroup waited for before the barrier; then
//    wgmma.wait_group 1, so one slab's wgmmas run under the next slab's
//    wait and barrier. The fence waits for the thread's copies in flight
//    too; a 128-byte slab holds enough tensor work to cover that.
//  * Epilogue: the accumulators go through shared memory (the ring is free
//    by then), 64 channels at a time, so that a warp stores 32 consecutive
//    pixels of one channel at once (64 bytes of bfloat16) where the direct
//    stores of the wgmma fragment used half of each 32-byte sector. A tile
//    that crosses a sample or passes N is masked.
//  * Traffic from L2, the 320 -> 256 head conv at 128 x 256 tiles: each
//    block reads its A rows and all of B once per slab, ~0.57 GB in all.
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
constexpr int kBM = 128;          // tile rows: two warpgroups of 64
constexpr int kBK = 128;          // bytes of K a stage holds: a slab
constexpr int kKStep = 32;        // bytes of K one wgmma takes
constexpr int kConvThreads = 256;
constexpr int kChunk = 16;        // bytes a cp.async copies
// the shared layout wgmma reads: K-major rows of kBK bytes with the
// 128-byte swizzle (descriptor layout type 1; chunk c of row r at r kBK +
// (c ^ r % 8) 16), 8-row groups kSBO apart; LBO is unused by a swizzled
// K-major operand (1, as CUTLASS sets it)
constexpr int kLayoutType = 1;
constexpr int kLBO = 16;
constexpr int kSBO = 8 * kBK;
constexpr int kEpiChannels = 64;  // channels a pass of the staged epilogue
constexpr int kEpiPitch = kBM + 4;          // int32 a staged channel row
// the launch plans implemented, (BN, stages): one ring depth for each tile
// width (ops/int8_conv.STAGES); 128 wide, two blocks share an SM
#define INT8_CONV_PLANS(X) X(256, 4) X(128, 3) X(64, 4)

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

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cp.async's writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// wgmma fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A shared-memory matrix descriptor (base offset 0: the ring starts on a
// 1024-byte boundary): start address, LBO and SBO, each in 16-byte units,
// and the layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)(kLBO >> 4) << 16 | (uint64_t)(kSBO >> 4) << 32 |
         (uint64_t)kLayoutType << 62;
}

#define D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
#define D32(i) D16(i), D16(i + 16)
#define D64(i) D32(i), D32(i + 32)
#define D128(i) D64(i), D64(i + 64)

// d += A (64 x 32, descriptor da) B^T (BN x 32, descriptor db), int8 in,
// int32 sums; issued by the 128 threads of a warpgroup together.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}"
        ", %32, %33, p;\n}\n"
        : D32(0)
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}"
        ", %64, %65, p;\n}\n"
        : D64(0)
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p;\n}\n"
        : D128(0)
        : "l"(da), "l"(db), "r"(1));
  }
};


#undef D4
#undef D16
#undef D32
#undef D64
#undef D128

struct ConvShape {
  int B, H, W, Cp, N, kh, kw, stride, pad, Ho, Wo;
};

// Grid (ceil(M / kBM), ceil(N / BN)); block kConvThreads; dynamic shared
// memory kStages (kBM + BN) kBK bytes.
template <int BN, int kStages, typename TOut>
__global__ void __launch_bounds__(kConvThreads, 1)
    int8_conv_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ sx,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ sw, TOut* __restrict__ out,
                     ConvShape sh) {
  constexpr int kABytes = kBM * kBK;
  constexpr int kStageBytes = (kBM + BN) * kBK;
  constexpr int kChunksRow = kBK / kChunk;               // 4
  constexpr int kRowsPass = kConvThreads / kChunksRow;   // rows a pass: 32
  constexpr int kARows = kBM / kRowsPass;                // A rows a thread
  constexpr int kBRows = BN / kRowsPass;                 // B rows a thread
  constexpr int kPassBytes = kRowsPass / 8 * kSBO;       // a pass's bytes
  static_assert(kStages >= 3, "the ring needs a slab in flight");
  static_assert(kEpiChannels * kEpiPitch * 4 <= kStages * kStageBytes,
                "the staged epilogue reuses the ring");
  extern __shared__ __align__(1024) int8_t smem[];

  const int tid = threadIdx.x;
  const int hw = sh.Ho * sh.Wo;
  const long long M = (long long)sh.B * hw;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int K = sh.kh * sh.kw * sh.Cp;
  const int KT = (K + kBK - 1) / kBK;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // the loader: this thread copies chunk kc of tile rows r + kRowsPass i
  // (A and B) to one shared offset within a tile. An A row's origin is the byte
  // offset in xq of its tap (0, 0) at channel 0, off the image where that
  // tap is in the padding; a row past M starts far above the image, so no
  // tap passes the bounds test. A B row past N has no bytes (klim 0).
  const int kc = tid % kChunksRow, r = tid / kChunksRow;
  const uint32_t dst = r * kBK + (kc ^ r % 8) * kChunk;
  long long a_org[kARows];
  int iy0[kARows], ix0[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long m = m0 + r + i * kRowsPass;
    const int b = m < M ? (int)(m / hw) : 0;
    const int p = m < M ? (int)(m - (long long)b * hw) : 0;
    const int oy = p / sh.Wo, ox = p - oy * sh.Wo;
    iy0[i] = oy * sh.stride - sh.pad;
    ix0[i] = ox * sh.stride - sh.pad;
    a_org[i] = (((long long)b * sh.H + iy0[i]) * sh.W + ix0[i]) * sh.Cp;
    if (m >= M) iy0[i] = INT_MIN / 2;
  }
  // its B rows n0 + r + kRowsPass j below N: j < b_rows
  const int8_t* wrow = wq + (size_t)(n0 + r) * K;
  const int b_rows = (sh.N - n0 - r + kRowsPass - 1) / kRowsPass;
  // the chunk's k offset, and its tap (ky, kx) and channel c: advanced by
  // a slab per load, the slabs loaded in order
  int k = kc * kChunk, c = k, kx = 0, ky = 0;
  auto settle = [&] {
    while (c >= sh.Cp) {
      c -= sh.Cp;
      if (++kx == sh.kw) kx = 0, ++ky;
    }
  };
  settle();
  auto load = [&](int stage) {
    const uint32_t a = sbase + stage * kStageBytes + dst;
    const long long tap = ((long long)ky * sh.W + kx) * sh.Cp + c;
    const bool k_ok = k < K;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const bool ok = k_ok && (unsigned)(iy0[i] + ky) < (unsigned)sh.H &&
                      (unsigned)(ix0[i] + kx) < (unsigned)sh.W;
      cp_async16(a + i * kPassBytes, ok ? xq + (a_org[i] + tap) : xq, ok);
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const bool ok = k_ok && j < b_rows;
      cp_async16(a + kABytes + j * kPassBytes,
                 ok ? wrow + ((size_t)j * kRowsPass * K + k) : wq, ok);
    }
    k += kBK;
    c += kBK;
    settle();
  };

  const int wg = tid / 128;   // this warpgroup's rows: 64 wg .. 64 wg + 63
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 3>();   // this thread's copies of slab kt
    fence_proxy_async();
    __syncthreads();                // everyone's; slab kt - 2 read by all
    const uint32_t st = sbase + (kt % kStages) * kStageBytes;
    const uint64_t da = smem_desc(st + wg * (64 / 8) * kSBO);
    const uint64_t db = smem_desc(st + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / kKStep; ++s)   // the next 32 bytes of the rows
      Wgmma<BN>::mma(acc, da + s * (kKStep >> 4), db + s * (kKStep >> 4));
    wgmma_commit();
    const int next = kt + kStages - 2;
    if (next < KT) load(next % kStages);
    cp_async_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();

  // epilogue. The fragment: warp w of the warpgroup holds rows 16 w +
  // lane / 4 (+ 8) and, in each 8-column group j, columns 8 j + 2 (lane %
  // 4) + {0, 1}: acc[4 j + 2 h + e] is row + 8 h, column + e.
  int* stage = reinterpret_cast<int*>(smem);
  const int warp = tid / 32, lane = tid % 32;
  const int frow = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int fcol = 2 * (lane % 4);
  // the store phase: this lane's pixels m0 + lane + 32 i
  constexpr int kPix = kBM / 32;
  size_t obase[kPix];
  float sxp[kPix];
  bool p_ok[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const long long m = m0 + lane + 32 * i;
    p_ok[i] = m < M;
    const int b = p_ok[i] ? (int)(m / hw) : 0;
    const int p = p_ok[i] ? (int)(m - (long long)b * hw) : 0;
    obase[i] = (size_t)b * sh.N * hw + p;
    sxp[i] = p_ok[i] ? sx[b] : 0.f;
  }
#pragma unroll
  for (int cc = 0; cc < BN / kEpiChannels; ++cc) {
    if (n0 + cc * kEpiChannels >= sh.N) break;
#pragma unroll
    for (int j = 0; j < kEpiChannels / 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        stage[(8 * j + fcol + v % 2) * kEpiPitch + frow + 8 * (v / 2)] =
            acc[4 * (cc * kEpiChannels / 8 + j) + v];
    __syncthreads();
    for (int nl = warp; nl < kEpiChannels; nl += kConvThreads / 32) {
      const int n = n0 + cc * kEpiChannels + nl;
      if (n >= sh.N) break;
      const float swn = sw[n];
#pragma unroll
      for (int i = 0; i < kPix; ++i)
        if (p_ok[i])
          store(out + obase[i] + (size_t)n * hw,
                __fmul_rn(__int2float_rn(stage[nl * kEpiPitch + lane + 32 * i]),
                          __fmul_rn(sxp[i], swn)));
    }
    __syncthreads();
  }
}


// The shared memory of an instantiation is fixed (its ring), so the
// attribute that allows it is set once a device, not at every launch (a
// CUDA API call on the host's path of every served conv).
template <int BN, int kStages, typename TOut>
cudaError_t conv(const int8_t* xq, const float* sx, const int8_t* wq,
                 const float* sw, void* out, const ConvShape& sh, dim3 grid,
                 int smem, int device, cudaStream_t s) {
  const auto kernel = int8_conv_kernel<BN, kStages, TOut>;
  static bool allowed[64];
  if (device < 0 || device >= 64 || !allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  kernel<<<grid, kConvThreads, smem, s>>>(xq, sx, wq, sw,
                                          static_cast<TOut*>(out), sh);
  return cudaGetLastError();
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
// [B,N,Ho,Wo] bfloat16 (out_bf16 = 1) or float32, by the launch plan of
// ops/int8_conv.int8_conv_plan: tile width bn, stages, dynamic shared
// memory bytes and grid, refused unless it is one this file implements and
// fits the shape. Returns a cudaError_t as an int.
int int8_conv_launch(const int8_t* xq, const float* sx, const int8_t* wq,
                     const float* sw, void* out, int out_bf16, int B, int H,
                     int W, int Cp, int N, int kh, int kw, int stride, int pad,
                     int Ho, int Wo, int device, void* stream, int bn,
                     int stages, int smem, int grid_x, int grid_y) {
  if (B <= 0 || N <= 0 || Ho <= 0 || Wo <= 0) return 0;
  const long long M = (long long)B * Ho * Wo;
  const long long m_blocks = (M + kBM - 1) / kBM;
  if (Cp <= 0 || Cp % kCinAlign != 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      pad < 0 || (Ho - 1) * stride - pad + kh > H + pad ||
      (Wo - 1) * stride - pad + kw > W + pad || m_blocks > INT_MAX ||
      (long long)Ho * Wo > INT_MAX || (long long)kh * kw * Cp > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (bn <= 0 || grid_x != m_blocks || grid_y != (N + bn - 1) / bn ||
      grid_y > 65535 || smem != stages * (kBM + bn) * kBK)
    return (int)cudaErrorInvalidValue;
  const ConvShape sh{B, H, W, Cp, N, kh, kw, stride, pad, Ho, Wo};
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
#define INT8_CONV_PLAN(BN, STAGES)                                          \
  if (bn == BN && stages == STAGES)                                         \
    return out_bf16 ? conv<BN, STAGES, __nv_bfloat16>(                      \
                          xq, sx, wq, sw, out, sh, grid, smem, device, s)   \
                    : conv<BN, STAGES, float>(xq, sx, wq, sw, out, sh,      \
                                              grid, smem, device, s);
    INT8_CONV_PLANS(INT8_CONV_PLAN)
#undef INT8_CONV_PLAN
    return cudaErrorInvalidValue;
  });
}

const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
